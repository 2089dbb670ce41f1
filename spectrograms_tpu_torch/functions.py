"""One-shot compute functions (the reference's pyfunction surface).

Counterpart of ``spectrograms_tpu.functions``: the 15
``compute_{linear,mel,erb,loghz,cqt}_{power,magnitude,db}_spectrogram``
functions, ``compute_stft``/``compute_fft``/``compute_rfft``/
``compute_power_spectrum``/``compute_magnitude_spectrum``/
``compute_irfft``/``compute_istft`` and ``FftPlanner``. Each takes
``dtype=`` and ``device=`` (CUDA unless ``device="cpu"``); the spectrogram
one-shots also take ``method=`` and ``precision=``.

The spectrogram one-shots reuse plans through an LRU cache of
``_MAX_CACHED_PLANS`` plans (the reference's global plan cache,
fft_backend.rs:947-1082). Its key is the JAX package's (params, scales,
scale and dB params, dtype, method) plus the resolved device and precision,
so a plan built for one device or precision tier is never served to a call
that asks for another.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .dtypes import Precision, parse_dtype, resolve_device
from .params import CqtParams, ErbParams, LogHzParams, LogParams, MelParams, SpectrogramParams
from .pipeline import AmpScale, FreqScale, SpectrogramPlan, SpectrogramPlanner, StftResult
from .ops import stft as _stft_ops

__all__ = [
    "compute_stft",
    "compute_fft",
    "compute_rfft",
    "compute_irfft",
    "compute_istft",
    "compute_power_spectrum",
    "compute_magnitude_spectrum",
    "clear_fft_plan_cache",
    "fft_plan_cache_info",
    # the 15 spectrogram one-shots are appended by _install_oneshots()
]

_MAX_CACHED_PLANS = 100  # MAX_CACHED_PLANS (fft_backend.rs:966)


@lru_cache(maxsize=_MAX_CACHED_PLANS)
def _cached_plan(params, scale, amp, scale_params, log_params, dtype_name, method, device,
                 precision):
    return SpectrogramPlan(params, scale, amp, scale_params=scale_params,
                           log_params=log_params, dtype=dtype_name, method=method,
                           precision=precision, device=device)


def get_plan(params, scale, amp, scale_params=None, log_params=None, dtype=None,
             method="auto", precision=None, device=None) -> SpectrogramPlan:
    """Fetch (or build) the cached plan of a one-shot configuration."""
    dt = parse_dtype(dtype)
    if precision is None:  # the plan's own default, so None and it share a plan
        precision = Precision.HIGHEST if dt == torch.float64 else Precision.HIGH
    return _cached_plan(params, scale, amp, scale_params, log_params,
                        str(dt).removeprefix("torch."), method, resolve_device(device),
                        precision)


def clear_fft_plan_cache() -> None:
    """Drop every cached plan (``clear_fft_plan_cache``)."""
    _cached_plan.cache_clear()


def fft_plan_cache_info() -> dict:
    """The plan cache's counters (``fft_plan_cache_info``)."""
    info = _cached_plan.cache_info()
    return {"hits": info.hits, "misses": info.misses, "size": info.currsize,
            "max_size": info.maxsize}


# ---- spectral one-shots ---------------------------------------------------

def compute_stft(samples, params: SpectrogramParams, dtype=None, device=None) -> StftResult:
    """Complex STFT of a signal under the given params."""
    return SpectrogramPlanner().compute_stft(samples, params, dtype=dtype, device=device)


def compute_fft(samples, n_fft: int, dtype=None, device=None):
    return _stft_ops.fft(samples, n_fft, dtype=dtype, device=device)


def compute_rfft(samples, n_fft: int, dtype=None, device=None):
    return _stft_ops.rfft(samples, n_fft, dtype=dtype, device=device)


def compute_irfft(spectrum, n_fft: int, dtype=None, device=None):
    return _stft_ops.irfft(spectrum, n_fft, dtype=dtype, device=device)


def compute_istft(stft_matrix, n_fft: int, hop_size: int, window="hanning", centre=True,
                  dtype=None, device=None):
    return _stft_ops.istft(stft_matrix, n_fft, hop_size, window, centre, dtype=dtype,
                           device=device)


def compute_power_spectrum(samples, n_fft: int, window=None, dtype=None, device=None):
    return _stft_ops.power_spectrum(samples, n_fft, window, dtype=dtype, device=device)


def compute_magnitude_spectrum(samples, n_fft: int, window=None, dtype=None, device=None):
    return _stft_ops.magnitude_spectrum(samples, n_fft, window, dtype=dtype, device=device)


# ---- the 15 spectrogram one-shots -----------------------------------------

_SCALE_TABLE = {
    "linear": (FreqScale.LINEAR, None),
    "mel": (FreqScale.MEL, MelParams),
    "erb": (FreqScale.ERB, ErbParams),
    "loghz": (FreqScale.LOG_HZ, LogHzParams),
    "cqt": (FreqScale.CQT, CqtParams),
}
_AMP_TABLE = {
    "power": AmpScale.POWER,
    "magnitude": AmpScale.MAGNITUDE,
    "db": AmpScale.DECIBELS,
}


def _install_oneshots():
    for scale_name, (scale, sp_type) in _SCALE_TABLE.items():
        for amp_name, amp in _AMP_TABLE.items():
            name = f"compute_{scale_name}_{amp_name}_spectrogram"

            def run(samples, params, scale_params, db, dtype, method, precision, device,
                    _s=scale, _a=amp):
                log_params = (db or LogParams()) if _a == AmpScale.DECIBELS else None
                return get_plan(params, _s, _a, scale_params, log_params, dtype, method,
                                precision, device).compute(samples)

            if sp_type is None:
                if amp == AmpScale.DECIBELS:
                    def fn(samples, params, db=None, dtype=None, method="auto", precision=None,
                           device=None, _run=run):
                        return _run(samples, params, None, db, dtype, method, precision, device)
                else:
                    def fn(samples, params, dtype=None, method="auto", precision=None,
                           device=None, _run=run):
                        return _run(samples, params, None, None, dtype, method, precision, device)
            else:
                if amp == AmpScale.DECIBELS:
                    def fn(samples, params, scale_params, db=None, dtype=None, method="auto",
                           precision=None, device=None, _run=run):
                        return _run(samples, params, scale_params, db, dtype, method, precision,
                                    device)
                else:
                    def fn(samples, params, scale_params, dtype=None, method="auto",
                           precision=None, device=None, _run=run):
                        return _run(samples, params, scale_params, None, dtype, method,
                                    precision, device)
            fn.__name__ = name
            fn.__doc__ = (
                f"One-shot {scale_name} {amp_name} spectrogram "
                f"(the PyO3 pyfunction of the same name)."
            )
            globals()[name] = fn
            __all__.append(name)


_install_oneshots()


class FftPlanner:
    """One-shot FFT wrapper (``FftPlanner``, spectrogram.rs:4977-5240).

    The reference caches twiddle plans per size; cuFFT keeps its own plan
    cache per size, so this class carries only the dtype and device.
    """

    def __init__(self, dtype=None, device=None):
        self._dtype = dtype
        self._device = device

    def fft(self, samples, n_fft: int):
        """Forward r2c FFT (zero-padded up to n_fft) → (n_fft//2+1,) complex."""
        return _stft_ops.fft(samples, n_fft, dtype=self._dtype, device=self._device)

    def rfft(self, samples, n_fft: int):
        """Magnitude of the r2c FFT (the reference's naming)."""
        return _stft_ops.rfft(samples, n_fft, dtype=self._dtype, device=self._device)

    def irfft(self, spectrum, n_fft: int):
        """c2r inverse FFT with 1/N normalization."""
        return _stft_ops.irfft(spectrum, n_fft, device=self._device)

    def power_spectrum(self, samples, n_fft: int, window=None):
        """|X|² of an optionally windowed zero-padded signal."""
        return _stft_ops.power_spectrum(samples, n_fft, window, dtype=self._dtype,
                                        device=self._device)

    def magnitude_spectrum(self, samples, n_fft: int, window=None):
        """|X| of an optionally windowed zero-padded signal."""
        return _stft_ops.magnitude_spectrum(samples, n_fft, window, dtype=self._dtype,
                                            device=self._device)


__all__.append("FftPlanner")
