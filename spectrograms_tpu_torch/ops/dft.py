"""Windowed real-DFT matrices for the plain matmul path, and their inverse.

Counterpart of ``spectrograms_tpu.ops.dft``: ``frames @ C`` is the real
part and ``frames @ S`` the imaginary part of ``rfft(frames * window)``;
``re @ Ci + im @ Si`` is ``irfft(re + 1j·im)``. Built in float64 NumPy and
cast at the edge.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["rdft_matrices", "irdft_matrices", "MATMUL_MAX_N_FFT"]

# Above this size the plans' ``auto`` method takes the FFT path (as in the
# JAX package).
MATMUL_MAX_N_FFT = 4096


@lru_cache(maxsize=64)
def _rdft_matrices_np(n_fft: int, window_key):
    """(n_fft, n_bins) cos / -sin matrices with the window folded in, f64."""
    n_bins = n_fft // 2 + 1
    j = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / n_fft
    cos = np.cos(ang)
    msin = -np.sin(ang)
    if window_key is not None:
        w = np.asarray(window_key, dtype=np.float64)[:, None]
        cos = cos * w
        msin = msin * w
    return cos, msin


def rdft_matrices(n_fft: int, window=None, dtype=torch.float32, device="cpu"):
    """Windowed real-DFT matrices (C, S), each (n_fft, n_bins) on ``device``."""
    window_key = (
        None if window is None
        else tuple(np.asarray(window, dtype=np.float64).tolist())
    )
    c, s = _rdft_matrices_np(int(n_fft), window_key)
    return (
        torch.tensor(c, dtype=dtype, device=device),
        torch.tensor(s, dtype=dtype, device=device),
    )


@lru_cache(maxsize=64)
def _irdft_matrices_np(n_fft: int):
    """(n_bins, n_fft) inverse real-DFT matrices, f64: the Hermitian weights
    (DC and Nyquist once, interior bins twice) and 1/N folded in."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    c = np.full((n_bins, 1), 2.0)
    c[0, 0] = 1.0
    if n_fft % 2 == 0:
        c[-1, 0] = 1.0
    return (c * np.cos(ang)) / n_fft, (-c * np.sin(ang)) / n_fft


def irdft_matrices(n_fft: int, dtype=torch.float32, device="cpu"):
    """Inverse real-DFT matrices (Ci, Si), each (n_bins, n_fft) on ``device``."""
    ci, si = _irdft_matrices_np(int(n_fft))
    return (
        torch.tensor(ci, dtype=dtype, device=device),
        torch.tensor(si, dtype=dtype, device=device),
    )
