"""Measured choice of a plan's ``method=`` lowering, with remembered winners.

Counterpart of ``spectrograms_tpu.autotune`` (FFTW's planner and "wisdom",
fft_backend.rs). ``autotune_plan`` rebuilds a plan under each candidate
``method=`` (``fft``, ``matmul``, and on a CUDA plan the fused kernels
``pallas`` and, with ``kernel_variants=True``, their forms ``pallas:dif``,
``pallas:stack``, ``pallas:dif+stack`` and ``pallas:gauss``), times each on
the plan's device and returns the fastest. Decisions are kept in
in-process *wisdom* keyed by (plan configuration, batch shape, device
type); ``save_wisdom``/``load_wisdom`` persist them as JSON so that a
serving job can skip the measurement.

The slope protocol, eagerly. The JAX package chains k calls inside one
jitted loop, so dispatch cancels out of the slope (k2 − k1 calls over
their time difference). PyTorch has no compiled chain of a ctypes kernel
launch, so here k1 and then k2 calls are enqueued back to back and timed
with CUDA events (on the CPU, the host clock), synchronizing once at the
end of each chain. Each call reads a clone of the sample whose first
element is written from a running sum of the previous outputs, kept on the
device (no host round trip per call; the caller's sample is never
written). The slope is then the per-call time in steady state: the larger
of the host's enqueue of one call and its device time. That is what a
serving loop pays, and it can differ from a kernel's device time alone
when the host is slower than the card.

Example::

    plan = tg.MfccPlan(tg.StftParams(1024, 256), 16000.0, dtype="float32")
    tuned = tg.autotune_plan(plan, sample_batch)   # AutotuneResult
    feats = tuned.plan.compute_batch(batch)
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .dtypes import Precision, numpy_dtype, result_data
from .errors import InvalidInputError

__all__ = [
    "AutotuneResult",
    "autotune",
    "autotune_plan",
    "wisdom",
    "clear_wisdom",
    "save_wisdom",
    "load_wisdom",
]

_WISDOM: Dict[str, str] = {}


@dataclass(frozen=True)
class AutotuneResult:
    """Outcome of an autotune run."""

    winner: str                      # label of the fastest candidate
    plan: object                     # winning plan (or callable for autotune())
    timings_ms: Dict[str, float]     # label -> measured ms per call ({} on cache hit)
    key: str                         # wisdom cache key
    from_cache: bool = False         # True when wisdom decided without measuring


def _slope_time(fn: Callable, x: torch.Tensor, k1: int, k2: int, reps: int) -> float:
    """Per-call seconds of ``fn`` on ``x`` by the eager slope protocol
    (module docstring)."""
    cuda = x.device.type == "cuda"

    def chain(k: int) -> float:
        xb = x.clone()
        first = xb.view(-1)[:1]
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        if cuda:
            torch.cuda.synchronize(x.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(k):
                # the data dependency: each call reads the previous outputs
                first.copy_((acc * 1e-30).to(xb.dtype).reshape(1))
                acc = acc + result_data(fn(xb)).sum().to(torch.float32)
        if cuda:
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    chain(1)  # the first call builds what it needs (a kernel's nvcc, caches)

    def timed(k: int) -> float:
        return min(chain(k) for _ in range(max(1, reps)))

    slopes = []
    for _ in range(2):
        d = (timed(k2) - timed(k1)) / (k2 - k1)
        if d > 0:
            slopes.append(d)
    return min(slopes) if slopes else timed(k2) / k2


def autotune(
    candidates: Dict[str, Callable],
    x_sample,
    *,
    k1: int = 1,
    k2: int = 65,
    reps: int = 5,
) -> AutotuneResult:
    """Measure labelled callables of the same meaning; return the fastest.

    Each candidate takes ``x_sample`` and returns a tensor (or an object
    with ``.data``). ``x_sample`` is used where it lies (a numpy array as a
    CPU tensor). Candidates are measured back to back on the same device.
    """
    if not candidates:
        raise InvalidInputError("autotune requires at least one candidate")
    x = torch.as_tensor(x_sample)
    timings = {label: _slope_time(fn, x, k1, k2, reps) * 1e3
               for label, fn in candidates.items()}
    winner = min(timings, key=timings.get)
    return AutotuneResult(
        winner=winner,
        plan=candidates[winner],
        timings_ms=timings,
        key="<callables>",
    )


def _rebuild_with_method(plan, method: str, device=None):
    """Rebuild a plan with another ``method=`` lowering, on ``device``
    (default: the plan's own)."""
    from .chroma import ChromaPlan
    from .mfcc import MfccPlan
    from .pipeline import SpectrogramPlan

    device = plan.device if device is None else device
    if isinstance(plan, MfccPlan):
        mp = plan._mel_plan
        return type(plan)(
            mp.params.stft,
            mp.params.sample_rate_hz,
            mel_params=mp.scale_params,
            mfcc_params=plan.mfcc_params,
            log_params=mp.log_params,
            dtype=plan._dtype,
            method=method,
            precision=mp.precision,
            device=device,
        )
    if isinstance(plan, ChromaPlan):
        # The plan's own full rate: under ChromaParams.multirate the helper
        # plan holds the decimated rate, and a rebuild at it would build a
        # full-rate plan for the wrong rate.
        return type(plan)(
            plan._stft,
            plan._sample_rate_hz,
            chroma_params=plan.params,
            dtype=plan._dtype,
            method=method,
            precision=plan._mag_plan.precision,
            device=device,
        )
    if isinstance(plan, SpectrogramPlan):
        # The typed subclasses (plans.MelDbPlan, ...) have narrower
        # __init__ signatures: rebuild through the base initializer on a
        # bare instance, which keeps the subclass.
        new = object.__new__(type(plan))
        SpectrogramPlan.__init__(
            new,
            plan.params,
            plan.freq_scale,
            plan.amp_scale,
            scale_params=plan.scale_params,
            log_params=plan.log_params,
            dtype=plan._dtype,
            method=method,
            precision=plan.precision,
            device=device,
        )
        return new
    raise InvalidInputError(
        f"autotune_plan supports SpectrogramPlan/MfccPlan/ChromaPlan, "
        f"got {type(plan).__name__}"
    )


def _spectrogram_plan(plan):
    """The ``SpectrogramPlan`` that carries a plan's geometry and dtype."""
    from .chroma import ChromaPlan
    from .mfcc import MfccPlan

    if isinstance(plan, MfccPlan):
        return plan._mel_plan
    if isinstance(plan, ChromaPlan):
        return plan._mag_plan
    return plan


def _plan_key(plan, batch_shape) -> str:
    from .chroma import ChromaPlan
    from .mfcc import MfccPlan

    mp = _spectrogram_plan(plan)
    if isinstance(plan, MfccPlan):
        kind, feat = "mfcc", str(plan.mfcc_params)
    elif isinstance(plan, ChromaPlan):
        kind, feat = "chroma", str(plan.params)
    else:
        kind, feat = type(plan).__name__.lower(), ""
    stft = mp.params.stft
    win_key = str(stft.window)
    coeffs = getattr(stft.window, "coefficients", None)
    if coeffs is not None:
        # str(Custom(n=N)) is one key for every custom window of length N:
        # hash the coefficients, so that wisdom is never applied to a
        # window it was not measured on.
        win_key += ":" + hashlib.sha1(
            np.asarray(coeffs, dtype=np.float64).tobytes()
        ).hexdigest()[:16]
    return json.dumps(
        [
            kind,
            stft.n_fft,
            stft.hop_size,
            bool(stft.centre),
            win_key,
            str(getattr(mp, "freq_scale", "")),
            str(getattr(mp, "amp_scale", "")),
            # the whole scale/log/feature configuration: the winner is
            # specific to it (a 32-mel winner is not a 128-mel one)
            str(getattr(mp, "scale_params", None)),
            str(getattr(mp, "log_params", None)),
            feat,
            numpy_dtype(mp._dtype).name,
            str(mp.precision),
            list(batch_shape),
            plan.device.type,
        ]
    )


def _candidate_methods(plan, kernel_variants: bool = False) -> Sequence[str]:
    from .ops.dft import MATMUL_MAX_N_FFT
    from .ops.fused_factored import supports_factored_fusion

    mp = _spectrogram_plan(plan)
    stft = mp.params.stft
    methods = ["fft"]
    if mp._dtype != torch.float64 and stft.n_fft <= MATMUL_MAX_N_FFT:
        methods.append("matmul")
    if (
        plan.device.type == "cuda"  # on the CPU the kernels run their plain versions
        and mp._dtype == torch.float32
        and mp.precision != Precision.HIGHEST
        and supports_factored_fusion(stft.n_fft, stft.hop_size, mp._dtype)
    ):
        methods.append("pallas")
        if kernel_variants:
            # The kernel's equivalent forms: which one wins depends on the
            # card and the shape, so measure them on this deployment.
            methods.append("pallas:dif")
            if mp.precision != Precision.DEFAULT:
                # stack is a form of the x3 tier (the factory rejects it
                # elsewhere); the bf16 tier is already Gauss.
                methods += ["pallas:stack", "pallas:dif+stack", "pallas:gauss"]
    return methods


def autotune_plan(
    plan,
    x_sample,
    *,
    methods: Optional[Sequence[str]] = None,
    kernel_variants: bool = False,
    k1: int = 1,
    k2: int = 65,
    reps: int = 5,
    use_wisdom: bool = True,
) -> AutotuneResult:
    """Return the measured-fastest ``method=`` lowering of ``plan``.

    ``x_sample`` has the serving shape: a 1-D signal or a (B, n) batch (the
    winner is specific to the shape); it is moved to the plan's device.
    With ``use_wisdom`` an earlier decision for the same (configuration,
    shape, device type) is reused without measuring, and a remembered
    method this plan can no longer take is dropped and tuned anew.
    ``kernel_variants=True`` also measures the fused kernels' forms.
    """
    from .chroma import ChromaPlan
    from .mfcc import MfccPlan
    from .pipeline import SpectrogramPlan

    if not isinstance(plan, (SpectrogramPlan, MfccPlan, ChromaPlan)):
        raise InvalidInputError(
            f"autotune_plan supports SpectrogramPlan/MfccPlan/ChromaPlan, "
            f"got {type(plan).__name__}"
        )
    x = torch.as_tensor(x_sample, dtype=plan._dtype, device=plan.device)
    if x.ndim not in (1, 2):
        raise InvalidInputError("x_sample must be a 1-D signal or (B, n) batch")
    key = _plan_key(plan, x.shape)
    if use_wisdom and key in _WISDOM:
        try:
            return AutotuneResult(
                winner=_WISDOM[key],
                plan=_rebuild_with_method(plan, _WISDOM[key]),
                timings_ms={},
                key=key,
                from_cache=True,
            )
        except InvalidInputError:
            # stale wisdom (a form this plan's tier no longer takes)
            _WISDOM.pop(key, None)

    chosen = (
        methods if methods is not None
        else _candidate_methods(plan, kernel_variants=kernel_variants)
    )
    variants = {}
    for m in chosen:
        try:
            variants[m] = _rebuild_with_method(plan, m)
        except InvalidInputError:
            continue  # a method this configuration cannot take
    if not variants:
        raise InvalidInputError("no candidate method applies to this plan")

    fns = {m: (v.compute_batch if x.ndim == 2 else v.compute) for m, v in variants.items()}
    result = autotune(fns, x, k1=k1, k2=k2, reps=reps)
    _WISDOM[key] = result.winner
    return AutotuneResult(
        winner=result.winner,
        plan=variants[result.winner],
        timings_ms=result.timings_ms,
        key=key,
    )


def wisdom() -> Dict[str, str]:
    """Copy of the in-process wisdom cache (key -> winning method)."""
    return dict(_WISDOM)


def clear_wisdom() -> None:
    _WISDOM.clear()


def save_wisdom(path) -> None:
    """Persist accumulated wisdom as JSON."""
    with open(path, "w") as f:
        json.dump(_WISDOM, f, indent=1, sort_keys=True)


def load_wisdom(path, *, merge: bool = True) -> Dict[str, str]:
    """Load wisdom saved by :func:`save_wisdom`; merges by default."""
    with open(path) as f:
        loaded = json.load(f)
    if not isinstance(loaded, dict):
        raise InvalidInputError("wisdom file must contain a JSON object")
    if not merge:
        _WISDOM.clear()
    _WISDOM.update({str(k): str(v) for k, v in loaded.items()})
    return dict(_WISDOM)
