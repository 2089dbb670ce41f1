"""Factorized real FFT: a 128-point DFT stage as products, then radix 2.

Counterpart of ``spectrograms_tpu.ops.fft_factored`` (``method="factored"``).
Two-stage Cooley-Tukey with N = 128·r:

    x[n], n = r·n₁ + n₂            (n₁ ∈ [0,128), n₂ ∈ [0,r))
    A[n₂, m]  = Σ_{n₁} x[r·n₁+n₂] · W₁₂₈^{n₁ m}        ← stage 1
    B[n₂, k₁] = W_N^{n₂ k₁} · A[n₂, k₁]                 ← twiddle
    X[k₁ + 128·k₂] = Σ_{n₂} B[n₂, k₁] · W_r^{n₂ k₂}     ← stage 2

Stage 1 is two real (…, 128) × (128, 128) products (cos, −sin), in true
f32 (or f64 for a float64 plan) where the JAX package asks for
``Precision.HIGHEST``; stage 2 is a radix-2 FFT of length r ≤ 32 over the
n₂ axis, elementwise. The result equals ``rfft(frames · window)`` to the
products' rounding. Every step is a differentiable tensor op, so gradients
come from autograd. The constants are built in f64 on the host
(``_constants_np``, a copy of JAX's) and cast once to the plan's dtype and
device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..dtypes import numpy_dtype, parse_dtype

__all__ = ["supports_factored", "FactoredRfft"]


def supports_factored(n_fft: int) -> bool:
    """True when n_fft = 128·r with r a power of two in [2, 32]."""
    if n_fft % 128 != 0:
        return False
    r = n_fft // 128
    return 2 <= r <= 32 and (r & (r - 1)) == 0


@lru_cache(maxsize=32)
def _constants_np(n_fft: int, dtype_str: str):
    """Host-built f64 constants cast to dtype: stage-1 DFT mats + twiddles."""
    r = n_fft // 128
    dt = np.dtype(dtype_str)
    n1 = np.arange(128, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n1, n1) / 128.0
    c128 = np.cos(ang).astype(dt)          # (128, 128): n1 → m
    s128 = (-np.sin(ang)).astype(dt)
    n2 = np.arange(r, dtype=np.float64)[:, None]
    k1 = np.arange(128, dtype=np.float64)[None, :]
    th = 2.0 * np.pi * n2 * k1 / n_fft
    tw_re = np.cos(th).astype(dt)          # (r, 128)
    tw_im = (-np.sin(th)).astype(dt)
    # Butterfly twiddles per radix-2 level of the length-r stage-2 FFT:
    # level ℓ operates on sub-FFTs of length L = 2^(ℓ+1); weights exp(-2πik/L)
    # for k < L/2, shaped (L/2, 1) to broadcast over the k₁ lane axis.
    butterflies = []
    length = 2
    while length <= r:
        k = np.arange(length // 2, dtype=np.float64)[:, None]
        w = np.exp(-2j * np.pi * k / length)
        butterflies.append((w.real.astype(dt), w.imag.astype(dt)))
        length *= 2
    return c128, s128, tw_re, tw_im, tuple(butterflies)


class FactoredRfft:
    """Windowed r2c FFT of (…, n_fft) frames → (re, im), each (…, n_bins).

    The window multiplies the frames before stage 1 (it varies with the
    whole index n = r·n₁+n₂, so it cannot fold into the shared stage-1
    matrix). Constants live on ``device`` in ``dtype``.
    """

    def __init__(self, n_fft: int, window=None, dtype=torch.float32, device="cpu"):
        if not supports_factored(n_fft):
            raise ValueError(
                f"factored FFT requires n_fft = 128 * 2^k, 256..4096; got {n_fft}"
            )
        self.n_fft = int(n_fft)
        self.r = self.n_fft // 128
        self.n_bins = self.n_fft // 2 + 1
        dt = parse_dtype(dtype)
        c, s, tw_re, tw_im, bfs = _constants_np(self.n_fft, numpy_dtype(dt).str)
        self._install(c, s, tw_re, tw_im, bfs, window, dt, torch.device(device))

    def _install(self, c, s, tw_re, tw_im, butterflies, window, dtype, device) -> None:
        """(Re)build the device constants from numpy arrays
        (``convert.factored_constants_from_numpy``)."""
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self._c, self._s, self._tw_re, self._tw_im = map(as_t, (c, s, tw_re, tw_im))
        self._bfs = [(as_t(re), as_t(im)) for re, im in butterflies]
        self._window = None if window is None else as_t(np.asarray(window, dtype=np.float64))

    # ---- length-r DFT over axis -2 (radix-2 DIT, unrolled on the host) -----
    def _small_fft(self, re, im, level: int):
        if re.shape[-2] == 1:
            return re, im
        e_re, e_im = self._small_fft(re[..., ::2, :], im[..., ::2, :], level - 1)
        o_re, o_im = self._small_fft(re[..., 1::2, :], im[..., 1::2, :], level - 1)
        w_re, w_im = self._bfs[level]
        wo_re = w_re * o_re - w_im * o_im
        wo_im = w_re * o_im + w_im * o_re
        return (
            torch.cat([e_re + wo_re, e_re - wo_re], dim=-2),
            torch.cat([e_im + wo_im, e_im - wo_im], dim=-2),
        )

    def __call__(self, frames):
        """(…, n_fft) real frames → (re, im), each (…, n_bins)."""
        x = frames if self._window is None else frames * self._window
        batch = x.shape[:-1]
        # x[r·n₁+n₂] → xr[n₂, n₁], contracted over n₁ with the 128-point DFT.
        xr = x.reshape(*batch, 128, self.r).transpose(-1, -2)
        a_re = xr @ self._c
        a_im = xr @ self._s
        b_re = a_re * self._tw_re - a_im * self._tw_im
        b_im = a_re * self._tw_im + a_im * self._tw_re
        x_re, x_im = self._small_fft(b_re, b_im, len(self._bfs) - 1)
        # Output index k = k₁ + 128·k₂ with layout [k₂, k₁] → flat row-major.
        out_re = x_re.reshape(*batch, self.n_fft)[..., : self.n_bins]
        out_im = x_im.reshape(*batch, self.n_fft)[..., : self.n_bins]
        return out_re, out_im

    def power(self, frames):
        """|rfft(frames·w)|²."""
        re, im = self(frames)
        return re * re + im * im
