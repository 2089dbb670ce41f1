"""2-D spectral ops as dense DFT products (the matmul route beside the FFT).

Counterpart of ``spectrograms_tpu.ops.spectral2d``. The full complex 2-D DFT
of a real H×W image is two chained matrix products ``F = D_H · x · D_W``
(D symmetric); a spectral filter is then ``y = real(D_H⁻¹ · (F ∘ K) ·
D_W⁻¹)``: twelve real (n, n) × (n, n) products a filter. Masks defined on
the rfft2 half layout are mirrored to the full layout (Hermitian
consistent), so the outputs match the FFT route to f32 rounding.

The products run in true f32 (``dtypes.check_true_f32``), where the JAX
package asks for ``Precision.HIGH``; so these functions take no precision.
``use_matmul_path`` is the rule that
``image_ops`` reads to pick a route; on CUDA it was decided from the card's
times of both routes (``chip_smoke.py`` phase 10, cited beside
``MATMUL_MAX_DIM``): cuFFT won at every size measured, so the rule picks
the FFT route everywhere.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..dtypes import check_true_f32, parse_dtype
from ..errors import InvalidInputError

__all__ = [
    "fft2_matmul",
    "ifft2_matmul_real",
    "full_mask_from_half",
    "full_spectrum_from_kernel",
    "spectral_filter_matmul",
    "spectral_conv_matmul",
    "MATMUL_MAX_DIM",
    "use_matmul_path",
]


@lru_cache(maxsize=8)
def _dft_consts_np(n: int):
    """(cos, sin) of the symmetric n-point DFT matrix, f32 (built in f64)."""
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / float(n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=16)
def _consts(n: int, dtype: torch.dtype, device: torch.device):
    """The (cos, sin) DFT matrices as tensors on ``device``, one copy each."""
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype) for a in _dft_consts_np(n))


def _operands(x):
    if x.is_cuda and x.dtype == torch.float32:
        check_true_f32()
    h, w = x.shape
    return _consts(h, x.dtype, x.device) + _consts(w, x.dtype, x.device)


def fft2_matmul(x):
    """Full complex 2-D DFT of a real image as (re, im) via real products."""
    ch, sh, cw, sw = _operands(x)
    t_re = x @ cw
    t_im = x @ sw
    f_re = ch @ t_re - sh @ t_im
    f_im = ch @ t_im + sh @ t_re
    return f_re, f_im


def ifft2_matmul_real(f_re, f_im):
    """Real part of the inverse full 2-D DFT (inputs Hermitian-symmetric)."""
    ch, sh, cw, sw = _operands(f_re)
    h, w = f_re.shape
    t_re = (ch @ f_re + sh @ f_im) / h
    t_im = (ch @ f_im - sh @ f_re) / h
    return (t_re @ cw + t_im @ sw) / w


def full_mask_from_half(m_half: np.ndarray, w: int) -> np.ndarray:
    """Mirror an (H, W//2+1) rfft2-layout real mask to the (H, W) full layout.

    irfft2 applies the half-layout mask to bins k ≤ W/2 and implicitly to
    their Hermitian partners; the full-layout equivalent mirrors columns
    W/2−1..1 (radial masks are row-wrap symmetric, so no row flip is needed
    for the mirrored block to be Hermitian-consistent).
    """
    if w % 2 != 0:
        raise ValueError("full-layout mirror requires even width")
    return np.concatenate([m_half, m_half[:, w // 2 - 1 : 0 : -1]], axis=1)


def full_spectrum_from_kernel(padded_kernel: np.ndarray) -> tuple:
    """(re, im) full-layout spectrum of a (real) FFT-padded kernel, f32."""
    spec = np.fft.fft2(padded_kernel.astype(np.float64))
    return spec.real.astype(np.float32), spec.imag.astype(np.float32)


def spectral_filter_matmul(img, mask_full: np.ndarray):
    """``real(ifft2(fft2(img) * mask))`` with a real full-layout mask."""
    f_re, f_im = fft2_matmul(img)
    m = torch.from_numpy(np.asarray(mask_full, dtype=np.float32)).to(img.device)
    return ifft2_matmul_real(f_re * m, f_im * m)


def spectral_conv_matmul(img, kspec_full: tuple):
    """Circular convolution via a full-layout complex spectrum multiply."""
    f_re, f_im = fft2_matmul(img)
    k_re, k_im = (torch.from_numpy(np.asarray(k, dtype=np.float32)).to(img.device)
                  for k in kspec_full)
    g_re = f_re * k_re - f_im * k_im
    g_im = f_re * k_im + f_im * k_re
    return ifft2_matmul_real(g_re, g_im)


# The largest side at which the matmul route beat cuFFT's rfft2 route on the
# card: none. chip_smoke.py phase 10 times both routes, a high-pass filter
# and a circular convolution, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (median of 100, L2 flushed): cuFFT 0.0275/0.0251 ms against the products'
# 0.3057/0.3711 ms at 256², 0.0309/0.0279 against 0.3891/0.5291 at 512², and
# 0.0445/0.0414 against 0.9896/1.4143 at 1024² (filter/conv). So the rule is
# False on CUDA at every size, and the products stay reachable through
# spectral_filter_matmul / spectral_conv_matmul.
MATMUL_MAX_DIM = 0


def _is_f32(dtype) -> bool:
    try:
        return parse_dtype(dtype) == torch.float32
    except InvalidInputError:
        return False


def use_matmul_path(shape, dtype, device=None) -> bool:
    """The route rule: f32, even sides in [8, MATMUL_MAX_DIM], on a CUDA
    device (``device`` defaults to CUDA, as the entry points do). Always
    False on the CPU, as the JAX package's rule is off its TPU."""
    if dtype is None or not _is_f32(dtype):
        return False
    h, w = shape
    if h % 2 or w % 2 or h > MATMUL_MAX_DIM or w > MATMUL_MAX_DIM:
        return False
    if h < 8 or w < 8:
        return False
    return torch.device("cuda" if device is None else device).type == "cuda"
