"""Named spans of the port's layers, on ``torch.profiler``'s clock.

``span(name)`` marks a stretch of host work. While a ``torch.profiler``
session records (``profiling.trace``, or any other), it is
``torch.profiler.record_function(name)``: Kineto writes it as a
``user_annotation`` event of the host thread, on the same clock as the
session's kernels, copies and CUDA launch calls. Otherwise it is one shared
no-op: one read of the profiler's flag, nothing allocated. The port keeps
no clock, buffer or switch of its own.

The names, one prefix a layer:

- ``tg.pipeline.loader_wait``: ``FeaturePipeline`` waiting on the loader
  for its next batch; ``tg.pipeline.upload``: the batch's copy to the
  device; ``tg.pipeline.step``: the stream wait, the dequantize and the
  plan; ``tg.pipeline.batch``: frame masks and the batch's wrapping;
- ``tg.plan.<class>``: a plan's forward from ``compute``,
  ``compute_batch`` (``compute_raw``, ``compute_into``) or a
  ``FeaturePipeline`` step, ``tg.plan.FeatureSet`` for a feature set;
- ``tg.member.<name>``: one member of a ``FeatureSet`` (a plan's class, or
  a callable's ``__name__``);
- ``tg.op.<module>.<function>``: a function that runs torch operations
  (``tg.op.mfcc.delta``, ``tg.op.decimate.decimate_pow2_framed``, ...);
- ``tg.kernel.<source>``: the launch of one of the CUDA kernels
  (``fused_features``, ``fused_tier_features``): layout, output
  allocation and the call into the library.

This module imports only torch.
"""

from __future__ import annotations

from torch.autograd import profiler as _profiler

__all__ = ["span"]


class _Off:
    """The span of a process that no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """``with span(name):`` records ``name`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)
