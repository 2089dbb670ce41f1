"""STFT, inverse STFT and the one-shot spectral functions, in torch.

Counterpart of ``spectrograms_tpu.ops.stft`` (the reference's one-shot
layer, ``src/spectrogram.rs:4483-4946``), with its semantics and errors:

- ``fft(samples, n_fft)``: r2c FFT, the input zero-padded up to ``n_fft``;
  an error if it is longer. ``n_fft//2+1`` complex bins;
- ``rfft``: ``|fft|`` (the reference's naming: the magnitude);
- ``power_spectrum``/``magnitude_spectrum``: optional window, |X|² / |X|;
- ``stft``: frames × r2c FFT → ([C,] n_bins, n_frames) complex;
- ``irfft``: c2r inverse with 1/N normalization;
- ``istft``: windowed overlap-add, normalized by the window energy (an f64
  host constant, guard 1e-10), centre padding stripped.

A ``(C, n)`` input is transformed per channel. Complex results are
complex64 at float32 and complex128 at float64. Every function computes on
``device`` (CUDA unless ``device="cpu"``); the dtype follows the input's
float dtype when ``dtype`` is not given.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import parse_dtype, resolve_device
from ..errors import DimensionMismatchError, InvalidInputError
from ..params import r2c_output_size
from ..windows import WindowType, make_window
from .framing import frame_signal
from .ola import overlap_add

__all__ = [
    "fft",
    "rfft",
    "irfft",
    "power_spectrum",
    "magnitude_spectrum",
    "stft",
    "istft",
]


def _signal_dtype(samples, dtype) -> torch.dtype:
    """``dtype``, else the input's float dtype, else the default."""
    return parse_dtype(dtype if dtype is not None else getattr(samples, "dtype", None))


def _as_signal(samples, dtype, device, what="(channels, n) input"):
    """A 1-D signal or a (channels, n) matrix on ``device`` in ``dtype``."""
    x = torch.as_tensor(samples, dtype=dtype, device=resolve_device(device))
    if x.ndim not in (1, 2):
        raise InvalidInputError(f"expected a 1-D signal or {what}, got shape {tuple(x.shape)}")
    if x.shape[-1] == 0:
        raise InvalidInputError("signal must be non-empty")
    return x


def _window(window, n_fft: int, dtype, device) -> torch.Tensor:
    return torch.tensor(make_window(window, n_fft, np.float64), dtype=dtype, device=device)


def _check_fits(x, n_fft: int) -> None:
    if x.shape[-1] > n_fft:
        raise InvalidInputError(f"Input length ({x.shape[-1]}) exceeds FFT size ({n_fft})")


def fft(samples, n_fft: int, dtype=None, device=None) -> torch.Tensor:
    """r2c FFT of a signal zero-padded up to ``n_fft`` → (n_fft//2+1,) complex.

    A multichannel ``(C, n)`` input transforms per channel → ``(C, n_bins)``.
    """
    x = _as_signal(samples, _signal_dtype(samples, dtype), device)
    _check_fits(x, n_fft)
    return torch.fft.rfft(x, n=int(n_fft), dim=-1)


def rfft(samples, n_fft: int, dtype=None, device=None) -> torch.Tensor:
    """Magnitude of the r2c FFT (the reference's ``rfft``)."""
    return fft(samples, n_fft, dtype, device).abs()


def irfft(spectrum, n_fft: int, dtype=None, device=None) -> torch.Tensor:
    """c2r inverse FFT with 1/N normalization → (n_fft,) real."""
    spec = torch.as_tensor(spectrum, device=resolve_device(device))
    expected = r2c_output_size(n_fft)
    if spec.shape[-1] != expected:
        raise DimensionMismatchError(expected, spec.shape[-1])
    out = torch.fft.irfft(spec, n=int(n_fft), dim=-1)
    return out if dtype is None else out.to(parse_dtype(dtype))


def power_spectrum(samples, n_fft: int, window: WindowType | None = None, dtype=None,
                   device=None) -> torch.Tensor:
    """|X|² of an (optionally windowed) zero-padded signal → (n_fft//2+1,)."""
    dt = _signal_dtype(samples, dtype)
    x = _as_signal(samples, dt, device)
    _check_fits(x, n_fft)
    if window is not None:
        if x.shape[-1] < n_fft:
            x = F.pad(x, (0, n_fft - x.shape[-1]))
        x = x * _window(window, n_fft, dt, x.device)
    spec = torch.fft.rfft(x, n=int(n_fft), dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).to(dt)


def magnitude_spectrum(samples, n_fft: int, window: WindowType | None = None, dtype=None,
                       device=None) -> torch.Tensor:
    """|X| of an (optionally windowed) zero-padded signal."""
    return torch.sqrt(power_spectrum(samples, n_fft, window, dtype, device))


def stft(
    samples,
    n_fft: int,
    hop_size: int,
    window: WindowType = WindowType.HANNING,
    centre: bool = True,
    dtype=None,
    device=None,
) -> torch.Tensor:
    """Short-time Fourier transform → (n_fft//2+1, n_frames) complex.

    A multichannel ``(C, n)`` input is transformed per channel in the same
    batched FFT → ``(C, n_bins, n_frames)``.
    """
    if hop_size > n_fft:
        raise InvalidInputError("hop_size must be <= n_fft")
    dt = _signal_dtype(samples, dtype)
    x = _as_signal(samples, dt, device, what="(channels, n) multichannel input")
    frames = frame_signal(x, int(n_fft), int(hop_size), bool(centre))  # (…, n_frames, n_fft)
    spec = torch.fft.rfft(frames * _window(window, n_fft, dt, x.device), n=int(n_fft), dim=-1)
    return spec.transpose(-1, -2)  # (…, n_bins, n_frames): the reference's layout


@lru_cache(maxsize=64)
def _ola_norm_np(window_key, n_fft, hop_size, n_frames, output_len):
    """Window-energy normalizer Σᵢ w²[t - i·hop] as an exact f64 host constant."""
    w2 = np.square(np.asarray(window_key, dtype=np.float64))
    norm = np.zeros(output_len, dtype=np.float64)
    for i in range(n_frames):
        norm[i * hop_size : i * hop_size + n_fft] += w2
    return norm


def istft(
    stft_matrix,
    n_fft: int,
    hop_size: int,
    window: WindowType = WindowType.HANNING,
    centre: bool = True,
    dtype=None,
    device=None,
) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add; input (n_bins, n_frames) complex.

    Normalizes by the accumulated window energy (guard 1e-10) and strips the
    centre padding (``istft``, spectrogram.rs:4860-4946).
    """
    spec = torch.as_tensor(stft_matrix, device=resolve_device(device))
    if spec.ndim != 2:
        raise InvalidInputError(f"stft_matrix must be 2-D, got shape {tuple(spec.shape)}")
    n_bins, n_frames = spec.shape
    expected = r2c_output_size(n_fft)
    if n_bins != expected:
        raise DimensionMismatchError(expected, n_bins)
    if hop_size > n_fft:
        raise InvalidInputError("hop_size must be <= n_fft")

    real_dt = torch.float64 if spec.dtype == torch.complex128 else torch.float32
    w64 = make_window(window, n_fft, np.float64)
    output_len = (n_frames - 1) * hop_size + n_fft
    norm = torch.tensor(
        _ola_norm_np(tuple(w64.tolist()), n_fft, hop_size, n_frames, output_len),
        dtype=real_dt, device=spec.device,
    )
    frames = torch.fft.irfft(spec.T, n=int(n_fft), dim=-1).to(real_dt)
    out = overlap_add(frames * torch.tensor(w64, dtype=real_dt, device=spec.device), hop_size)
    out = torch.where(norm > 1e-10, out / torch.where(norm == 0, 1.0, norm), out)

    pad = n_fft // 2 if centre else 0
    unpadded_len = max(0, output_len - 2 * pad)
    if centre and unpadded_len > 0:
        out = out[pad : pad + unpadded_len]
    return out if dtype is None else out.to(parse_dtype(dtype))
