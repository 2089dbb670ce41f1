"""2-D real FFT, shifts and frequency helpers.

Counterpart of ``spectrograms_tpu.fft2d`` (the reference's ``fft2d.rs``):
``fft2d`` (real → complex (rows, cols//2+1)), ``ifft2d(spectrum,
output_ncols)`` with 1/(r·c) normalization, the power and magnitude
spectra, ``fftshift``/``ifftshift`` (every axis) and their ``_1d`` forms,
``fftfreq``/``rfftfreq`` (numpy, as in the JAX package) and the
``Fft2dPlanner`` that namespaces them with a dtype (cuFFT caches its own
plans per shape).

float64 runs natively on the card (cuFFT D2Z/Z2D). Entry points compute on
CUDA unless given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .dtypes import complex_dtype, numpy_dtype, parse_dtype, resolve_device
from .errors import DimensionMismatchError, InvalidInputError

__all__ = [
    "fft2d",
    "ifft2d",
    "power_spectrum_2d",
    "magnitude_spectrum_2d",
    "fftshift",
    "ifftshift",
    "fftshift_1d",
    "ifftshift_1d",
    "fftfreq",
    "rfftfreq",
    "Fft2dPlanner",
]


def _as_image(data, dtype=None, device=None) -> torch.Tensor:
    dt = parse_dtype(dtype if dtype is not None else getattr(data, "dtype", None))
    x = torch.as_tensor(data, dtype=dt, device=resolve_device(device))
    if x.ndim != 2:
        raise InvalidInputError(f"expected a 2-D array, got shape {tuple(x.shape)}")
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise InvalidInputError("dimensions must be > 0")
    return x


def fft2d(data, dtype=None, device=None) -> torch.Tensor:
    """2-D r2c FFT → (nrows, ncols//2+1) complex."""
    return torch.fft.rfft2(_as_image(data, dtype, device))


def ifft2d(spectrum, output_ncols: int, dtype=None, device=None) -> torch.Tensor:
    """Inverse of :func:`fft2d`; needs the original column count."""
    s = torch.as_tensor(spectrum, device=resolve_device(device))
    if s.ndim != 2:
        raise InvalidInputError(f"expected a 2-D spectrum, got shape {tuple(s.shape)}")
    if s.shape[0] == 0 or output_ncols <= 0:
        raise InvalidInputError("dimensions must be > 0")
    expected = output_ncols // 2 + 1
    if s.shape[1] != expected:
        raise DimensionMismatchError(expected, s.shape[1])
    out = torch.fft.irfft2(s, s=(s.shape[0], int(output_ncols)))
    return out if dtype is None else out.to(parse_dtype(dtype))


def power_spectrum_2d(data, dtype=None, device=None) -> torch.Tensor:
    """|FFT2(x)|²."""
    spec = fft2d(data, dtype, device)
    return spec.real ** 2 + spec.imag ** 2


def magnitude_spectrum_2d(data, dtype=None, device=None) -> torch.Tensor:
    """|FFT2(x)|."""
    return torch.sqrt(power_spectrum_2d(data, dtype, device))


def _shift_cast(arr, dtype, device) -> torch.Tensor:
    x = torch.as_tensor(arr, device=resolve_device(device))
    if dtype is not None:
        dt = parse_dtype(dtype)
        x = x.to(complex_dtype(dt) if x.is_complex() else dt)
    return x


def fftshift(arr, dtype=None, device=None) -> torch.Tensor:
    """Shift DC to the array centre (every axis)."""
    return torch.fft.fftshift(_shift_cast(arr, dtype, device))


def ifftshift(arr, dtype=None, device=None) -> torch.Tensor:
    """Inverse of :func:`fftshift`."""
    return torch.fft.ifftshift(_shift_cast(arr, dtype, device))


def fftshift_1d(arr, dtype=None, device=None) -> torch.Tensor:
    return torch.fft.fftshift(_shift_cast(arr, dtype, device))


def ifftshift_1d(arr, dtype=None, device=None) -> torch.Tensor:
    return torch.fft.ifftshift(_shift_cast(arr, dtype, device))


def fftfreq(n: int, d: float = 1.0, dtype=np.float64) -> np.ndarray:
    """FFT bin frequencies (numpy.fft.fftfreq semantics)."""
    if n <= 0:
        raise InvalidInputError("n must be > 0")
    return np.fft.fftfreq(int(n), float(d)).astype(numpy_dtype(parse_dtype(dtype)))


def rfftfreq(n: int, d: float = 1.0, dtype=np.float64) -> np.ndarray:
    """Positive FFT bin frequencies for the real FFT (n//2+1 values)."""
    if n <= 0:
        raise InvalidInputError("n must be > 0")
    return np.fft.rfftfreq(int(n), float(d)).astype(numpy_dtype(parse_dtype(dtype)))


class Fft2dPlanner:
    """Caching 2-D FFT planner (API parity with ``Fft2dPlanner``): the free
    functions with a dtype and a device. cuFFT keeps its own per-shape
    plan cache."""

    def __init__(self, dtype=None, device=None):
        # Validated eagerly (the reference planner rejects bad dtype strings).
        self._dtype = None if dtype is None else str(parse_dtype(dtype)).removeprefix("torch.")
        self.device = resolve_device(device)

    @property
    def dtype(self) -> str:
        """Configured dtype name (default float32)."""
        return self._dtype if self._dtype is not None else str(parse_dtype(None)).removeprefix(
            "torch.")

    def fft2d(self, data):
        return fft2d(data, self._dtype, self.device)

    def ifft2d(self, spectrum, output_ncols: int):
        return ifft2d(spectrum, output_ncols, dtype=self._dtype, device=self.device)

    def power_spectrum_2d(self, data):
        return power_spectrum_2d(data, self._dtype, self.device)

    def magnitude_spectrum_2d(self, data):
        return magnitude_spectrum_2d(data, self._dtype, self.device)
