"""Double-double (f32×2) arithmetic, op for op as in the JAX package.

Counterpart of ``spectrograms_tpu.ops.dd``. A value is an (hi, lo) pair of
float32 tensors with ``value = hi + lo`` and |lo| ≤ ulp(hi)/2, about 49
bits of mantissa from f32 operations, by the classical error-free
transformations (Dekker 1971, Knuth TAOCP §4.2.2):

- ``two_sum``: the 6-flop branch-free exact sum;
- ``_split``/``two_prod``: Dekker splitting (products of 12-bit halves are
  exact);
- the renormalizing ``dd_add``/``dd_mul``/``dd_sqrt``;
- on top of them a radix-2 complex FFT (``dd_fft``), the real-input
  ``dd_rfft``, their inverses, a tree sum and a matrix-vector product.

The transformations are exact only if each rounded product and the split's
``4097·a`` are rounded on their own, so every step here is a separate
elementwise tensor op (``+ - *``), never a fused one (``addcmul``, ``lerp``,
a matmul, ``torch.compile``). Eager PyTorch rounds each op, so the JAX
package's ``_detach`` guard against compiler contraction has no work here.
``two_sum``, ``_split``, ``two_prod`` and ``dd_add`` give JAX's bits on the
CPU; ``dd_mul`` does not, since XLA's CPU backend contracts
``x.hi·y.lo + x.lo·y.hi`` into an FMA and PyTorch rounds the product.

The H100 computes in native float64, so the port's ``method="f32x2"`` tier
and ``x2.py`` compute in f64 on the device and split the result; this
module is their op-for-op plain version (the JAX package's arithmetic),
held by the tests against JAX and against f64, and timed on the card
beside the f64 route.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import resolve_device

__all__ = [
    "dd", "dd_from_f64", "dd_to_f64", "two_sum", "two_prod",
    "dd_add", "dd_sub", "dd_mul", "dd_sqrt", "dd_fft", "dd_rfft",
    "dd_ifft", "dd_irfft", "dd_matvec", "dd_tree_sum",
]

_SPLITTER = 4097.0  # 2^12 + 1, for the f32 Dekker split
# Elements of one (..., rows, n_in) product block in ``dd_matvec``.
_MATVEC_BLOCK = 1 << 22


def _device_of(x, device):
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def dd(hi, lo=None, device=None):
    """Make a dd pair from f32 array(s)."""
    dev = _device_of(hi, device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    lo = torch.zeros_like(hi) if lo is None else torch.as_tensor(lo, dtype=torch.float32,
                                                                 device=dev)
    return (hi, lo)


def dd_from_f64(x, device=None) -> tuple:
    """Split an f64 array into an (hi, lo) f32 pair (~2^-48 relative): hi
    is the correctly rounded f32 value, lo the f32 of the remainder."""
    x = torch.as_tensor(x, dtype=torch.float64, device=_device_of(x, device))
    hi = x.float()
    return (hi, (x - hi.double()).float())


def dd_to_f64(v) -> np.ndarray:
    """Recombine a pair in f64 on the host."""
    hi, lo = v
    as64 = lambda a: (a.detach().cpu().double().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a, dtype=np.float64))
    return as64(hi) + as64(lo)


def two_sum(a, b):
    """Error-free a+b → (s, err), branch-free Knuth version."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """two_sum requiring |a| ≥ |b| (3 flops)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    """Dekker split: a = hi + lo with 12-bit halves (exact f32 products)."""
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free a·b → (p, err) via Dekker splitting."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def dd_add(x, y):
    """Full dd + dd: ~2 ulp of dd precision."""
    s, e = two_sum(x[0], y[0])
    t, f = two_sum(x[1], y[1])
    e = e + t
    s, e = _quick_two_sum(s, e)
    e = e + f
    return _quick_two_sum(s, e)


def dd_neg(x):
    return (-x[0], -x[1])


def dd_sub(x, y):
    return dd_add(x, dd_neg(y))


def dd_mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _quick_two_sum(p, e)


def dd_sqrt(x):
    """dd sqrt by one Newton/Karp step off the f32 estimate: for x ≥ 0,
    s ≈ √x to f32, then s + (x − s²)/(2s) in dd."""
    s0 = torch.sqrt(torch.clamp_min(x[0], 0.0))
    s0d = (s0, torch.zeros_like(s0))
    num = dd_sub(x, dd_mul(s0d, s0d))
    # num is O(2^-24)·x, so dividing its halves by 2·s0 in f32 is enough.
    d = 2.0 * s0
    pos = s0 > 0
    safe = torch.where(pos, d, 1.0)
    corr = (torch.where(pos, num[0] / safe, 0.0), torch.where(pos, num[1] / safe, 0.0))
    return dd_add(s0d, corr)


# ---- complex dd: z = (re, im), each a dd pair ------------------------------


def _cadd(a, b):
    return (dd_add(a[0], b[0]), dd_add(a[1], b[1]))


def _csub(a, b):
    return (dd_sub(a[0], b[0]), dd_sub(a[1], b[1]))


def _cmul(a, b):
    re = dd_sub(dd_mul(a[0], b[0]), dd_mul(a[1], b[1]))
    im = dd_add(dd_mul(a[0], b[1]), dd_mul(a[1], b[0]))
    return (re, im)


@lru_cache(maxsize=64)
def _twiddles(n: int, device: torch.device):
    """dd twiddle constants e^{-2πik/n}, k < n/2, built in f64 on the host."""
    ang = -2.0 * np.pi * np.arange(n // 2, dtype=np.float64) / n
    return (dd_from_f64(np.cos(ang), device), dd_from_f64(np.sin(ang), device))


@lru_cache(maxsize=64)
def _bitrev(n: int, device: torch.device) -> torch.Tensor:
    bits = int(np.log2(n))
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return torch.as_tensor(rev, device=device)


def dd_fft(z, n: int):
    """Radix-2 DIF complex FFT over the last axis (length n = 2^k).

    ``z`` = ((re_hi, re_lo), (im_hi, im_lo)). Breadth first: log₂n stages
    over the whole array, each a reshape, one dd butterfly and one twiddle
    product, then one bit-reversal gather.
    """
    if n < 1 or n & (n - 1):
        raise ValueError(f"dd_fft needs a power-of-two length, got {n}")
    if n == 1:
        return z
    (reh, rel), (imh, iml) = z
    lead = tuple(reh.shape[:-1])
    # view (..., B, m): B independent sub-FFTs of size m
    arrs = [a.reshape(*lead, 1, n) for a in (reh, rel, imh, iml)]
    m = n
    while m > 1:
        half = m // 2
        reh, rel, imh, iml = arrs
        a = ((reh[..., :half], rel[..., :half]), (imh[..., :half], iml[..., :half]))
        b = ((reh[..., half:], rel[..., half:]), (imh[..., half:], iml[..., half:]))
        s = _cadd(a, b)  # even-output subproblem
        d = _csub(a, b)
        if m > 2:
            d = _cmul(d, _twiddles(m, reh.device))  # odd-output subproblem
        # stack even/odd along a new axis → (..., 2B, m/2)
        arrs = []
        for part in (0, 1):  # re, im
            for comp in (0, 1):  # hi, lo
                st = torch.stack([s[part][comp], d[part][comp]], dim=-2)  # (..., B, 2, half)
                arrs.append(st.reshape(*st.shape[:-3], -1, half))
        m = half
    # the B-axis index is bit-reversed k: undo it with one gather
    rev = _bitrev(n, arrs[0].device)
    out = [a.reshape(*lead, n).index_select(-1, rev) for a in arrs]
    return ((out[0], out[1]), (out[2], out[3]))


def dd_rfft(x, n: int):
    """Real-input FFT: dd pair (..., n) → complex dd (..., n//2+1) bins."""
    zero = (torch.zeros_like(x[0]), torch.zeros_like(x[1]))
    re, im = dd_fft((x, zero), n)
    sl = lambda a: a[..., : n // 2 + 1]
    return ((sl(re[0]), sl(re[1])), (sl(im[0]), sl(im[1])))


def dd_ifft(z, n: int):
    """Inverse complex FFT over the last axis (length n = 2^k): conj,
    forward :func:`dd_fft`, conj, scaled by 1/n (a power of two, so the
    scale is exact on both halves)."""
    (reh, rel), (imh, iml) = z
    re, im = dd_fft(((reh, rel), (-imh, -iml)), n)
    s = 1.0 / n
    return ((re[0] * s, re[1] * s), (-im[0] * s, -im[1] * s))


def dd_irfft(spec, n: int):
    """Inverse real FFT: complex dd (..., n//2+1) bins → real dd (..., n).

    Rebuilds the Hermitian full spectrum (bin n−k = conj(bin k)) by slicing,
    exact in dd, then :func:`dd_ifft`; the imaginary output is dropped."""
    (reh, rel), (imh, iml) = spec

    def full(a, sign):
        # [a0 .. a_{n/2}, sign·a_{n/2-1} .. sign·a_1]
        return torch.cat([a, sign * a[..., 1:-1].flip(-1)], dim=-1)

    z = ((full(reh, 1.0), full(rel, 1.0)), (full(imh, -1.0), full(iml, -1.0)))
    re, _ = dd_ifft(z, n)
    return re


def dd_tree_sum(p):
    """Tree-reduce a dd pair over the last axis with dd adds (a log₂-depth
    binary tree, padded with exact zeros): one f32 accumulator would clamp
    the sum back to 2^-24."""
    n_in = p[0].shape[-1]
    width = 1 << int(np.ceil(np.log2(max(n_in, 1))))
    acc = (F.pad(p[0], (0, width - n_in)), F.pad(p[1], (0, width - n_in)))
    while width > 1:
        half = width // 2
        acc = dd_add((acc[0][..., :half], acc[1][..., :half]),
                     (acc[0][..., half:], acc[1][..., half:]))
        width = half
    return (acc[0][..., 0], acc[1][..., 0])


def dd_matvec(m, v):
    """(n_out, n_in) dd matrix · (..., n_in) dd → (..., n_out).

    Each output is ``dd_tree_sum`` of elementwise ``dd_mul(v, row)``, as in
    the JAX package's scan over rows; here a block of rows at a time, at
    most ``_MATVEC_BLOCK`` product elements, which bounds the memory and
    leaves each output's arithmetic unchanged."""
    m_hi, m_lo = m
    n_out, n_in = m_hi.shape
    v_hi, v_lo = v[0].unsqueeze(-2), v[1].unsqueeze(-2)  # (..., 1, n_in)
    rows = max(1, _MATVEC_BLOCK // max(1, v_hi.numel()))
    his, los = [], []
    for r0 in range(0, n_out, rows):
        hi, lo = dd_tree_sum(dd_mul((v_hi, v_lo), (m_hi[r0:r0 + rows], m_lo[r0:r0 + rows])))
        his.append(hi)
        los.append(lo)
    return (torch.cat(his, dim=-1), torch.cat(los, dim=-1))
