"""Minimum-phase FIR conversion via the real cepstrum (homomorphic method).

Counterpart of ``spectrograms_tpu.min_phase`` (the reference's
``min_phase.rs``): an FFT at ``next_pow2(len·oversample)`` (8× by default),
log|H| with an ``eps = max|H|²·1e-20`` guard (1e-300 when H is all zero),
the inverse FFT to the real cepstrum, the causal-doubling window (DC and
Nyquist weight 1, 2× strictly between, anticausal zeroed), ``exp(FFT(c))``,
the inverse FFT, cut to ``out_len``. The complex dtype follows the input:
complex128 for float64, else complex64. Computes on CUDA unless given
``device="cpu"``.
"""

from __future__ import annotations

import torch

from .convolution import next_power_of_two
from .dtypes import complex_dtype, parse_dtype, resolve_device
from .errors import InvalidInputError

__all__ = ["minimum_phase", "minimum_phase_with", "DEFAULT_OVERSAMPLE"]

DEFAULT_OVERSAMPLE = 8


def _min_phase(ir, n: int, take: int):
    h = torch.fft.fft(ir, n=n)
    mag2 = h.real ** 2 + h.imag ** 2
    max_mag2 = mag2.max()
    eps = torch.where(max_mag2 > 0, max_mag2 * 1e-20, 1e-300)
    log_mag = 0.5 * torch.log(mag2 + eps)
    cep = torch.fft.ifft(log_mag.to(complex_dtype(ir.dtype)))
    weights = torch.zeros(n, dtype=ir.dtype, device=ir.device)
    half = n // 2
    weights[0] = 1.0
    weights[1:half] = 2.0
    weights[half] = 1.0  # Nyquist (n is a power of two, even for n > 1)
    h_min = torch.exp(torch.fft.fft(cep * weights))
    return torch.fft.ifft(h_min).real[:take].to(ir.dtype)


def minimum_phase_with(ir, out_len: int, oversample: int = DEFAULT_OVERSAMPLE, dtype=None,
                       device=None) -> torch.Tensor:
    """Minimum-phase conversion with explicit output length and oversampling."""
    dt = parse_dtype(dtype if dtype is not None else getattr(ir, "dtype", None))
    x = torch.as_tensor(ir, dtype=dt, device=resolve_device(device)).reshape(-1)
    if x.shape[0] == 0:
        raise InvalidInputError("impulse response must not be empty")
    if out_len <= 0:
        raise InvalidInputError("out_len must be greater than zero")
    oversample = max(1, int(oversample))
    n = next_power_of_two(x.shape[0] * oversample)
    return _min_phase(x, n, min(int(out_len), n))


def minimum_phase(ir, dtype=None, device=None) -> torch.Tensor:
    """Same-length minimum-phase equivalent of an FIR impulse response."""
    return minimum_phase_with(ir, torch.as_tensor(ir).shape[-1], DEFAULT_OVERSAMPLE, dtype,
                              device)
