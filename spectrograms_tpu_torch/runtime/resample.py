"""Sample-rate conversion for the host data path.

Counterpart of ``spectrograms_tpu.runtime.resample``: bandlimited
interpolation with a Kaiser-windowed sinc (the librosa/resampy family), each
output sample a dot product of ``2*half_width`` input taps against the
kernel at the exact fractional input position, the cutoff scaled to
``min(1, ratio)`` so that downsampling is anti-aliased. The loader uses it
for ``on_rate_mismatch="resample"``. The native library's polyphase kernel
runs the default design; other designs run the numpy kernel below.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..errors import InvalidInputError
from .native import NativeUnavailable, load_library

__all__ = ["resample"]


def _native_resample(x, sr_in: float, sr_out: float):
    """The C++ kernel's result, or None without the native library."""
    try:
        lib = load_library()
    except NativeUnavailable:
        return None
    xc = np.ascontiguousarray(x, dtype=np.float32)
    out_len = int(np.ceil(xc.shape[0] * sr_out / sr_in))
    out = np.empty(out_len, dtype=np.float32)
    # The buffer's capacity rides along: the C++ side clamps to it, so a
    # rounding disagreement on the length can never write past the end.
    n = lib.sg_resample(
        xc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), xc.shape[0], sr_in, sr_out,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_len,
    )
    if n < 0:
        return None
    return out[:n]


def _kaiser_beta(attenuation_db: float) -> float:
    a = attenuation_db
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def resample(x, sr_in: float, sr_out: float, half_width: int = 32,
             attenuation_db: float = 90.0) -> np.ndarray:
    """Resample a 1-D signal from ``sr_in`` to ``sr_out`` Hz.

    Output length is ``ceil(n * sr_out / sr_in)``; float32 in → float32 out
    (f64 inside the kernel math).
    """
    x = np.asarray(x)
    if x.ndim != 1:
        raise InvalidInputError(f"expected a 1-D signal, got shape {x.shape}")
    if sr_in <= 0 or sr_out <= 0:
        raise InvalidInputError("sample rates must be positive")
    if x.shape[0] == 0:
        return x.copy()
    if float(sr_in) == float(sr_out):
        return np.array(x, copy=True)
    if np.dtype(x.dtype) == np.float32 and half_width == 32 and attenuation_db == 90.0:
        native = _native_resample(x, float(sr_in), float(sr_out))
        if native is not None:
            return native

    in_dtype = x.dtype
    xf = x.astype(np.float64)
    n = xf.shape[0]
    ratio = float(sr_out) / float(sr_in)
    # n·sr_out first, then the division, as the loader and the native side
    # compute it (ceil(n·(sr_out/sr_in)) differs at exact rational boundaries).
    out_len = int(np.ceil(n * float(sr_out) / float(sr_in)))
    cutoff = min(1.0, ratio)
    beta = _kaiser_beta(attenuation_db)

    # A 512-phase table with linear interpolation, as the C++ kernel tabulates.
    phases = 512
    k = np.arange(-half_width + 1, half_width + 1, dtype=np.float64)
    fr_grid = np.arange(phases + 1, dtype=np.float64)[:, None] / phases
    u_tab = k[None, :] - fr_grid
    z = u_tab / half_width
    h_tab = cutoff * np.sinc(cutoff * u_tab) * np.where(
        np.abs(z) < 1.0,
        np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - z * z))) / np.i0(np.asarray(beta)),
        0.0,
    )

    out = np.empty(out_len, dtype=np.float64)
    chunk = 1 << 20
    ki = np.arange(-half_width + 1, half_width + 1, dtype=np.int64)
    for start in range(0, out_len, chunk):
        stop = min(start + chunk, out_len)
        t = np.arange(start, stop, dtype=np.float64) / ratio
        base = np.floor(t).astype(np.int64)
        frac = t - base
        idx = base[:, None] + ki[None, :]
        valid = (idx >= 0) & (idx < n)
        gathered = np.where(valid, xf[np.clip(idx, 0, n - 1)], 0.0)
        pf = frac * phases
        p0 = pf.astype(np.int64)
        alpha = (pf - p0)[:, None]
        weights = h_tab[p0] + alpha * (h_tab[p0 + 1] - h_tab[p0])
        out[start:stop] = np.einsum("mk,mk->m", gathered, weights)
    return out.astype(in_dtype if np.issubdtype(in_dtype, np.floating) else np.float64)
