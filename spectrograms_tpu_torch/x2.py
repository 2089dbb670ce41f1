"""The f64-grade tier beyond the spectrogram plans: the STFT round trip and
the 2-D FFT, returned as (hi, lo) float32 pairs.

Counterpart of ``spectrograms_tpu.x2``. A real value is a pair ``(hi, lo)``
with value ``hi + lo`` (``ops.dd.dd_to_f64`` recombines it); a complex
value is ``((re_hi, re_lo), (im_hi, im_lo))``. The JAX package computes the
pairs in double-double on f32 hardware because its TPU has no f64. The
H100 has native float64, so each function here computes in f64 on the
device (cuFFT D2Z/Z2Z and the port's ``stft``/``istft`` at float64) and
splits the result: ``hi`` is the correctly rounded f32 value and ``lo`` the
f32 of the remainder. A pair given as input is recombined exactly as
``hi.double() + lo.double()``. ``ops/dd.py`` keeps the op-for-op dd
arithmetic as the plain version.

The checks, shapes and error types are JAX's: power-of-two sizes (the JAX
dd FFT is radix-2) and, for ``istft_x2``, a hop that divides ``n_fft``.
Entry points compute on CUDA unless given ``device="cpu"``.
"""

from __future__ import annotations

import torch

from .dtypes import resolve_device
from .errors import DimensionMismatchError, InvalidInputError
from .ops import stft as stft_ops
from .ops.dd import dd_from_f64
from .params import r2c_output_size

__all__ = ["stft_x2", "istft_x2", "fft2d_x2", "ifft2d_x2"]


def _pow2_check(n: int, what: str) -> None:
    if n < 2 or n & (n - 1):
        raise InvalidInputError(
            f"the f32x2 tier needs a power-of-two {what}, got {n} "
            "(the dd FFT is radix-2)"
        )


def _pairs(pairs, device):
    """Nested (hi, lo) pairs of arrays → f32 tensors on ``device``."""
    return tuple(tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in p)
                 for p in pairs)


def _join(pair) -> torch.Tensor:
    hi, lo = pair
    return hi.double() + lo.double()


def stft_x2(samples, n_fft: int, hop_size: int, window="hanning", centre: bool = True,
            device=None):
    """STFT at f64 grade: f32 signal → complex pair (n_bins, n_frames) each.

    Returns ``((re_hi, re_lo), (im_hi, im_lo))``, the pair form of
    :func:`spectrograms_tpu_torch.stft` of the signal in float64.
    """
    _pow2_check(int(n_fft), "n_fft")
    x = torch.as_tensor(samples, dtype=torch.float32, device=resolve_device(device))
    if x.ndim != 1 or x.shape[0] == 0:
        raise InvalidInputError("expected a non-empty 1-D signal")
    if hop_size <= 0 or hop_size > n_fft:
        raise InvalidInputError("need 0 < hop_size <= n_fft")
    spec = stft_ops.stft(x.double(), int(n_fft), int(hop_size), window, bool(centre),
                         device=x.device)
    return (dd_from_f64(spec.real), dd_from_f64(spec.imag))


def istft_x2(spec_x2, n_fft: int, hop_size: int, window="hanning", centre: bool = True,
             device=None):
    """Inverse STFT at f64 grade: complex pair bins → signal pair (hi, lo).

    The pair form of :func:`spectrograms_tpu_torch.istft` (windowed
    overlap-add, window-energy normalization, centre padding stripped).
    Requires ``hop_size | n_fft``, as the JAX package's dd overlap-add does.
    """
    _pow2_check(int(n_fft), "n_fft")
    if hop_size <= 0 or n_fft % hop_size:
        raise InvalidInputError("istft_x2 requires hop_size dividing n_fft")
    re, im = _pairs(spec_x2, resolve_device(device))
    if re[0].ndim != 2:
        raise InvalidInputError(f"expected (n_bins, n_frames), got {tuple(re[0].shape)}")
    expected = r2c_output_size(int(n_fft))
    if re[0].shape[0] != expected:
        raise DimensionMismatchError(expected, re[0].shape[0])
    out = stft_ops.istft(torch.complex(_join(re), _join(im)), int(n_fft), int(hop_size),
                         window, bool(centre), device=re[0].device)
    return dd_from_f64(out)


def fft2d_x2(data, device=None):
    """2-D r2c FFT at f64 grade → complex pair (nrows, ncols//2+1) each;
    needs power-of-two dimensions."""
    x = torch.as_tensor(data, dtype=torch.float32, device=resolve_device(device))
    if x.ndim != 2:
        raise InvalidInputError(f"expected a 2-D array, got shape {tuple(x.shape)}")
    _pow2_check(int(x.shape[0]), "row count")
    _pow2_check(int(x.shape[1]), "column count")
    spec = torch.fft.rfft2(x.double())
    return (dd_from_f64(spec.real), dd_from_f64(spec.imag))


def ifft2d_x2(spec_x2, output_ncols: int, device=None):
    """Inverse of :func:`fft2d_x2` → real pair (hi, lo)."""
    re, im = _pairs(spec_x2, resolve_device(device))
    if re[0].ndim != 2:
        raise InvalidInputError(f"expected a 2-D spectrum, got {tuple(re[0].shape)}")
    nr, nc = int(re[0].shape[0]), int(output_ncols)
    _pow2_check(nr, "row count")
    _pow2_check(nc, "column count")
    if re[0].shape[1] != nc // 2 + 1:
        raise DimensionMismatchError(nc // 2 + 1, int(re[0].shape[1]))
    return dd_from_f64(torch.fft.irfft2(torch.complex(_join(re), _join(im)), s=(nr, nc)))
