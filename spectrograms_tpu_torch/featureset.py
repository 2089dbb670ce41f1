"""Multi-feature steps: several plans over one batch, one shared front end.

Counterpart of ``spectrograms_tpu.featureset``. Production feature
extraction rarely wants one feature: a music pipeline computes chroma and
MFCC over the same clips, and each multirate plan decimates the same signal.
``FeatureSet`` runs N plans over one batch and shares one
:class:`~spectrograms_tpu_torch.ops.decimate.DecimationCascade` between every
member whose decimation front end matches (same composite mode and
precision key). Sharing is exact for single-stage members (mel / log-Hz /
chroma at depth ≤ 2 get bit-identical inputs: the cascade's pad is zeros and
the banded decimator already zero-extends); deeper chained levels differ
from a standalone cascade only near the signal's ends.

The JAX package traces the step into one program. Here the card's
equivalent is a CUDA graph: on a CUDA batch, ``compute_batch`` and
``compute`` replay the cascade and the plan members as one graph, captured
once for each input signature on the second call in a row with it; the first
call of a signature runs eagerly and warms every cache. A signature is the
batch's (shape, dtype, device), the float32 matmul precision (which the
eager step's guards read and a graph freezes) and ``cache.generation``,
which ``clear_fft_plan_cache`` and the ``convert`` functions that install
new constants into a plan move: a graph of an older generation is dropped,
not replayed. The graph keeps the tensors it read that were made before its
capture (cached band matrices, a plan's constants), so no cache eviction can
free memory that a replay reads. Callable members are the caller's code,
which the set cannot prove safe to capture (a host sync, a data-dependent
shape, a side effect), so they run eagerly after the replay, on the caller's
batch and stream. The graph's plan members are the same launches with the
same arguments, so their answers are the eager step's. A batch on the CPU,
one that requires grad, or a call on a stream that is already capturing
runs eagerly. Module counters: ``graph_captures``, ``graph_replays``,
``graph_eager_steps`` (CUDA steps that did not replay) and
``graph_capture_failures`` (a signature whose capture raised runs eagerly
from then on). A replay adds the kernels it runs to their ``.launches``
counters, as a launch from the host would.

>>> import numpy as np, spectrograms_tpu_torch as tg
>>> ch = tg.ChromaPlan(tg.StftParams(4096, 1024), 44100.0,
...                    tg.ChromaParams.music_standard().with_multirate(), device="cpu")
>>> (chroma,) = tg.FeatureSet([ch]).compute_batch(np.zeros((2, 44100), np.float32))
>>> tuple(chroma.shape)
(2, 12, 44)
"""

from __future__ import annotations

import threading
import warnings
import weakref
from typing import Sequence

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

from . import cache
from .errors import InvalidInputError
from .ops._build import add_launches, launch_counts
from .ops.decimate import DecimationCascade
from .spans import span

__all__ = ["FeatureSet"]

graph_captures = 0          # CUDA graphs captured
graph_replays = 0           # steps whose plan members were replayed from a graph
graph_eager_steps = 0       # CUDA steps that did not replay
graph_capture_failures = 0  # captures that raised: their signature stays eager


def _is_plan(m) -> bool:
    """A port plan: it has the FeatureSet hooks (``_fs_cascade_spec``,
    ``_fs_forward_batch``)."""
    return hasattr(m, "_fs_forward_batch")


class _Reads(TorchFunctionMode):
    """Weak references to every tensor the torch calls under it take. A
    function mode, not a dispatch mode: entering the first dispatch mode of
    a process imports torch's compiler stack, seconds of set-up."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.refs += [weakref.ref(t) for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
        return func(*args, **kwargs)

    def alive(self) -> list:
        """The tensors taken that are still alive: those made before the
        recorded calls, or kept after them. Intermediates are gone, so
        keeping the rest costs no memory."""
        return list({id(t): t for t in (r() for r in self.refs) if t is not None}.values())


class _CudaGraphs:
    """The CUDA graph calls of a graphed step, in one place, so that a test
    can put a fake recorder here (``featureset._cuda``)."""

    @staticmethod
    def follow(cur, prev, x) -> None:
        """Order a replay on ``cur`` after the last one on ``prev``; ``x``
        (the static input) is then in use on ``cur`` too."""
        cur.wait_stream(prev)
        x.record_stream(cur)

    @staticmethod
    def capture(fn, x):
        """``fn`` (a tensor → a list of tensors) as a CUDA graph over a copy
        of ``x``: (static input, static outputs, replay, the tensors made
        before the capture that the graph reads). As torch documents, ``fn``
        runs once on a side stream before the capture there; the caller's
        stream then waits for the side stream, also when a step raises."""
        cur = torch.cuda.current_stream(x.device)
        static = x.clone(memory_format=torch.contiguous_format)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(cur)
        try:
            with torch.cuda.stream(side):
                fn(static)
                graph = torch.cuda.CUDAGraph()
                # thread_local: the capture forbids unsafe calls on this
                # thread only, not on the caller's other threads
                with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                    with _Reads() as reads:
                        outs = fn(static)
        finally:
            cur.wait_stream(side)
        return static, outs, graph.replay, reads.alive()


_cuda = _CudaGraphs()


def _signature(xb: torch.Tensor) -> tuple:
    """What a captured graph is valid for: the batch's shape, dtype and
    device, the float32 matmul precision and the constants' generation."""
    return (tuple(xb.shape), xb.dtype, xb.device,
            (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()),
            cache.generation)


class _Graph:
    """A captured step: its signature, static input and outputs, the replay,
    the tensors made before the capture that it reads, the launches a replay
    runs (one count per counter) and the stream of the last replay."""

    __slots__ = ("key", "x", "outs", "replay", "keep", "launched", "stream")

    def __init__(self, key, x, outs, replay, keep, launched):
        self.key, self.x, self.outs, self.replay = key, x, outs, replay
        self.keep, self.launched = keep, launched
        self.stream = None


class FeatureSet:
    """Compute several feature plans over the same batch.

    ``members`` are port plans (``SpectrogramPlan``, ``MfccPlan``,
    ``ChromaPlan``) and/or callables ``f(batch) -> tensor`` for custom
    stages. Plan members share one dtype and one device; callables get the
    batch on that device.

    ``compute_batch(batch)`` returns a tuple of results in member order;
    ``compute(samples)`` maps one 1-D signal through a singleton batch.
    Each result is what the member's own ``compute_batch`` returns (see the
    module docstring for deep shared levels), a fresh tensor on every call.

    On a CUDA batch the plan members run as one CUDA graph from the second
    call in a row with the same signature on (the batch's shape, dtype and
    device, the float32 matmul precision and the constants' generation: see
    the module docstring); a call with another signature runs eagerly and
    keeps the graph, and two calls in a row with it replace the graph.
    Callable members run eagerly after the plan members, in member order.
    The set holds one graph, its static input, its private memory pool and
    the tensors made before the capture that it reads; its replays run on
    the caller's current stream.
    """

    _span = "tg.plan.FeatureSet"

    def __init__(self, members: Sequence):
        if not members:
            raise InvalidInputError("FeatureSet needs at least one member")
        self._members = list(members)
        self._member_spans = ["tg.member." + (type(m).__name__ if _is_plan(m)
                                              else getattr(m, "__name__", type(m).__name__))
                              for m in self._members]
        self._specs = []
        dtypes, devices = set(), set()
        for m in self._members:
            if not _is_plan(m):
                if not callable(m):
                    raise InvalidInputError(
                        f"FeatureSet member {m!r} is neither a plan with a "
                        "batched forward nor a callable"
                    )
                self._specs.append(None)
                continue
            self._specs.append(m._fs_cascade_spec())
            dtypes.add(m._dtype)
            devices.add(m.device)
        if len(dtypes) > 1:
            raise InvalidInputError(
                f"FeatureSet members must share one dtype, got "
                f"{sorted(str(d).removeprefix('torch.') for d in dtypes)}"
            )
        if len(devices) > 1:
            raise InvalidInputError(
                f"FeatureSet members must share one device, got {sorted(map(str, devices))}"
            )
        self._dtype = dtypes.pop() if dtypes else torch.float32
        # A set of callables alone computes where its input lies.
        self.device = devices.pop() if devices else None

        # Cascade flavours: members with equal (composite, precision) share
        # one cascade padded to the largest member pad, rounded up to the
        # deepest level's 2^d so that every member's slice stays on its grid.
        flavors: dict = {}
        for spec in self._specs:
            if spec is None:
                continue
            composite, precision, pad, depths = spec
            cur_pad, cur_dmax = flavors.get((composite, precision), (0, 0))
            flavors[(composite, precision)] = (max(cur_pad, pad), max(cur_dmax, max(depths)))
        self._flavors = {
            key: -(-pad // (1 << dmax)) * (1 << dmax) for key, (pad, dmax) in flavors.items()
        }
        self._has_plans = any(map(_is_plan, self._members))
        self._graph = None        # the captured step, a _Graph
        self._last_key = None     # signature of the previous eager or replayed CUDA call
        self._eager_keys = set()  # signatures whose capture raised
        self._graph_lock = threading.Lock()

    @property
    def n_members(self) -> int:
        return len(self._members)

    def _plans_step(self, xb: torch.Tensor) -> list:
        """The plan members' results over (B, n) ``xb``, in member order:
        the shared cascades and every plan, what a graph captures."""
        cascades = {
            key: DecimationCascade(xb, pad=pad, precision=key[1], composite=key[0])
            for key, pad in self._flavors.items()
        }
        outs = []
        for m, spec, name in zip(self._members, self._specs, self._member_spans):
            if _is_plan(m):
                with span(name):
                    outs.append(m._fs_forward_batch(xb, None if spec is None
                                                    else cascades[(spec[0], spec[1])]))
        return outs

    def _with_callables(self, planned: list, xb: torch.Tensor) -> tuple:
        """Results in member order: ``planned`` for the plans, and each
        callable run on ``xb`` after them."""
        planned = iter(planned)
        outs = []
        for m, name in zip(self._members, self._member_spans):
            if _is_plan(m):
                outs.append(next(planned))
            else:
                with span(name):
                    outs.append(m(xb))
        return tuple(outs)

    def _step_impl(self, xb: torch.Tensor) -> tuple:
        """Every member over a (B, n) tensor on the set's device, eagerly."""
        return self._with_callables(self._plans_step(xb), xb)

    def _run(self, xb: torch.Tensor) -> tuple:
        """The step over ``xb``: the plan members replayed from the set's
        CUDA graph where the call allows it (see the class docstring)."""
        global graph_eager_steps
        if not xb.is_cuda:
            return self._step_impl(xb)
        key = _signature(xb)
        graphable = (self._has_plans and not xb.requires_grad
                     and not torch.cuda.is_current_stream_capturing())
        if graphable:
            with self._graph_lock:
                planned = self._replayed(xb, key)
            if planned is not None:
                return self._with_callables(planned, xb)
        graph_eager_steps += 1
        out = self._step_impl(xb)
        if graphable:
            self._last_key = key
        return out

    def _replayed(self, xb: torch.Tensor, key):
        """The plan members' results replayed from the graph of ``key``,
        cloned out of its static outputs; None where the call runs eagerly.
        The graph of another signature is replaced on the second call in a
        row with ``key``, and dropped at once when its constants' generation
        has moved; a capture that raises leaves ``key`` eager."""
        global graph_captures, graph_replays, graph_capture_failures
        g = self._graph
        if g is not None and g.key[-1] != key[-1]:
            self._graph = g = None  # its constants were dropped or replaced
        if g is None or g.key != key:
            if key != self._last_key or key in self._eager_keys:
                return None
            self._graph = None  # frees the old graph's pool before the capture
            launched = []

            def step(x):
                before = launch_counts()
                outs = self._plans_step(x)
                launched[:] = [b - a for a, b in zip(before, launch_counts())]
                return outs

            try:
                g = _Graph(key, *_cuda.capture(step, xb), tuple(launched))
            except Exception as e:  # whatever broke the capture, the eager step still runs
                graph_capture_failures += 1
                self._eager_keys.add(key)
                warnings.warn(f"FeatureSet: CUDA graph capture of a {key[0]} {key[1]} step "
                              f"failed, the signature runs eagerly: {e!r}", RuntimeWarning,
                              stacklevel=4)
                return None
            # the capture's launches are recorded, not run: a replay counts them
            add_launches(g.launched, -1)
            graph_captures += 1
            self._graph = g
        cur = torch.cuda.current_stream(xb.device)
        if g.stream is not None and g.stream != cur:
            _cuda.follow(cur, g.stream, g.x)
        g.stream = cur
        g.x.copy_(xb)
        g.replay()
        add_launches(g.launched)
        graph_replays += 1
        self._last_key = key
        return [o.clone() for o in g.outs]

    def compute_batch(self, batch) -> tuple:
        """Run every member over (batch, samples) → tuple of results."""
        with span(self._span):
            xb = torch.as_tensor(batch, dtype=self._dtype, device=self.device)
            if xb.ndim != 2:
                raise InvalidInputError(
                    f"expected a (batch, samples) array, got shape {tuple(xb.shape)}"
                )
            return self._run(xb)

    def compute(self, samples) -> tuple:
        """Run every member over one 1-D signal → tuple of results."""
        with span(self._span):
            x = torch.as_tensor(samples, dtype=self._dtype, device=self.device)
            if x.ndim != 1 or x.shape[0] == 0:
                raise InvalidInputError("expected a non-empty 1-D signal")
            return tuple(r[0] for r in self._run(x[None, :]))
