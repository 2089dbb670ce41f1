"""FFT-based image filtering: blur, low/high/band-pass, edges, sharpen.

Counterpart of ``spectrograms_tpu.image_ops`` (the reference's
``image_ops.rs``):

- ``convolve_fft``: the kernel wrap-padded so that its centre lands at
  (0, 0) (on the device: zero padding, then a roll; a kernel already on
  the device crosses nothing from the host), FFT multiply, inverse
  (circular, same-size output);
- ``gaussian_kernel_2d``: odd size, normalized to sum 1 (numpy);
- circular binary masks measured on the rfft2 spectrum layout with the
  reference's periodic-wrap distance, built on the host (``lru_cache``) and
  copied once to each device they are used on;
- ``detect_edges_fft`` = high-pass at 0.1; ``sharpen_fft`` = img +
  amount·high-pass(0.2).

Each filter takes cuFFT's rfft2 route, or the dense-product route of
``ops.spectral2d`` where ``use_matmul_path`` picks it. Entry points compute
on CUDA unless given ``device="cpu"``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .dtypes import numpy_dtype, parse_dtype
from .errors import InvalidInputError
from .fft2d import _as_image, fft2d, ifft2d
from .ops.spectral2d import (
    full_mask_from_half,
    full_spectrum_from_kernel,
    spectral_conv_matmul,
    spectral_filter_matmul,
    use_matmul_path,
)

__all__ = [
    "convolve_fft",
    "gaussian_kernel_2d",
    "lowpass_filter",
    "highpass_filter",
    "bandpass_filter",
    "detect_edges_fft",
    "sharpen_fft",
]


def _pad_kernel_for_fft(kernel: np.ndarray, target_shape) -> np.ndarray:
    """Wrap-pad so the kernel centre sits at (0, 0) (periodic boundary)."""
    tr, tc = target_shape
    kr, kc = kernel.shape
    out = np.zeros((tr, tc), dtype=kernel.dtype)
    rows = (np.arange(kr) - kr // 2) % tr
    cols = (np.arange(kc) - kc // 2) % tc
    out[np.ix_(rows, cols)] = kernel
    return out


def _pad_kernel_on(kernel: torch.Tensor, target_shape) -> torch.Tensor:
    """``_pad_kernel_for_fft`` on the kernel's device: zero-pad, then roll
    the centre to (0, 0)."""
    (tr, tc), (kr, kc) = target_shape, kernel.shape
    k = F.pad(kernel, (0, tc - kc, 0, tr - kr))
    return torch.roll(k, shifts=(-(kr // 2), -(kc // 2)), dims=(0, 1))


def convolve_fft(image, kernel, dtype=None, device=None) -> torch.Tensor:
    """Circular FFT convolution with a centred kernel (same-size output).

    ``kernel`` may be a tensor on the image's device: it is then padded
    there, and the call copies nothing from the host (a host array is
    copied to the device first, which waits for the device's queue).
    """
    img = _as_image(image, dtype, device)
    if not isinstance(kernel, torch.Tensor):
        kernel = np.asarray(kernel, dtype=np.float64)
    ker = torch.as_tensor(kernel, device=img.device)
    if ker.ndim != 2:
        raise InvalidInputError("kernel must be 2-D")
    if ker.shape[0] == 0 or ker.shape[1] == 0:
        raise InvalidInputError("kernel dimensions must be > 0")
    if ker.shape[0] > img.shape[0] or ker.shape[1] > img.shape[1]:
        raise InvalidInputError("kernel dimensions must not exceed image dimensions")
    if use_matmul_path(tuple(img.shape), img.dtype, img.device):
        padded = _pad_kernel_for_fft(ker.double().cpu().numpy(), tuple(img.shape))
        return spectral_conv_matmul(img, full_spectrum_from_kernel(padded)).to(img.dtype)
    k = _pad_kernel_on(ker.double().to(img.dtype), tuple(img.shape))
    return torch.fft.irfft2(torch.fft.rfft2(img) * torch.fft.rfft2(k), s=tuple(img.shape))


def gaussian_kernel_2d(size: int, sigma: float, dtype=np.float64) -> np.ndarray:
    """Odd ``size × size`` Gaussian kernel normalized to sum 1."""
    if size <= 0 or size % 2 == 0:
        raise InvalidInputError("kernel size must be odd and > 0")
    if sigma <= 0.0:
        raise InvalidInputError("sigma must be > 0")
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
    return g.astype(numpy_dtype(parse_dtype(dtype)))


@lru_cache(maxsize=64)
def _lowpass_mask(shape, cutoff_fraction: float) -> np.ndarray:
    """Binary circular mask on the rfft2 spectrum layout (DC at (0, 0)), with
    the reference's periodic-wrap distance over the *spectrum* dims."""
    nrows, ncols = shape
    i = np.arange(nrows, dtype=np.float64)
    j = np.arange(ncols, dtype=np.float64)
    freq_row = np.where(i <= nrows // 2, i, np.abs(i - nrows))
    freq_col = np.where(j <= ncols // 2, j, np.abs(j - ncols))
    max_radius_sq = (min(nrows // 2, ncols // 2) * cutoff_fraction) ** 2
    dist_sq = freq_row[:, None] ** 2 + freq_col[None, :] ** 2
    mask = (dist_sq <= max_radius_sq).astype(np.float64)
    mask.setflags(write=False)
    return mask


def _band_mask(shape, low: Optional[float], high: Optional[float]) -> np.ndarray:
    """The half-layout mask that keeps the ring between ``low`` and ``high``:
    low-pass(high) − low-pass(low), where a missing cutoff is the whole
    plane (high) or nothing (low)."""
    keep = 1.0 if high is None else _lowpass_mask(shape, high)
    return keep - (0.0 if low is None else _lowpass_mask(shape, low))


@lru_cache(maxsize=64)
def _device_mask(shape, low, high, dtype: torch.dtype, device: torch.device):
    """``_band_mask`` on ``device`` in ``dtype``, copied there once."""
    return torch.as_tensor(_band_mask(shape, low, high), dtype=dtype, device=device)


def _check_fraction(name: str, v: float):
    if not (0.0 <= v <= 1.0):
        raise InvalidInputError(f"{name} must be between 0.0 and 1.0")


def _mask_filter(img, low: Optional[float], high: Optional[float]) -> torch.Tensor:
    """Apply the half-layout ring mask through the route the rule picks."""
    half = (img.shape[0], img.shape[1] // 2 + 1)
    if use_matmul_path(tuple(img.shape), img.dtype, img.device):
        m_full = full_mask_from_half(_band_mask(half, low, high), img.shape[1])
        return spectral_filter_matmul(img, m_full)
    mask = _device_mask(half, low, high, img.dtype, img.device)
    return ifft2d(fft2d(img, device=img.device) * mask, img.shape[1], device=img.device).to(
        img.dtype)


def lowpass_filter(image, cutoff_fraction: float, dtype=None, device=None) -> torch.Tensor:
    """Keep frequencies inside the circular cutoff (smoothing)."""
    _check_fraction("cutoff_fraction", cutoff_fraction)
    return _mask_filter(_as_image(image, dtype, device), None, float(cutoff_fraction))


def highpass_filter(image, cutoff_fraction: float, dtype=None, device=None) -> torch.Tensor:
    """Remove frequencies inside the circular cutoff (edge emphasis)."""
    _check_fraction("cutoff_fraction", cutoff_fraction)
    return _mask_filter(_as_image(image, dtype, device), float(cutoff_fraction), None)


def bandpass_filter(image, low_cutoff: float, high_cutoff: float, dtype=None,
                    device=None) -> torch.Tensor:
    """Keep frequencies between the two circular cutoffs."""
    _check_fraction("low_cutoff", low_cutoff)
    _check_fraction("high_cutoff", high_cutoff)
    if low_cutoff >= high_cutoff:
        raise InvalidInputError("high_cutoff must be greater than low_cutoff")
    return _mask_filter(_as_image(image, dtype, device), float(low_cutoff), float(high_cutoff))


def detect_edges_fft(image, dtype=None, device=None) -> torch.Tensor:
    """Edge detection via high-pass filtering at cutoff 0.1."""
    return highpass_filter(image, 0.1, dtype=dtype, device=device)


def sharpen_fft(image, amount: float, dtype=None, device=None) -> torch.Tensor:
    """Sharpen: original + ``amount`` × high-pass(0.2)."""
    if amount < 0.0:
        raise InvalidInputError("amount must be >= 0")
    img = _as_image(image, dtype, device)
    return img + highpass_filter(img, 0.2, device=img.device) * float(amount)
