"""Host-side layout of the factored DFT, for the bf16 precision tiers.

The port's own copy of what ``spectrograms_tpu.ops.pallas_factored`` builds
on the host for its Pallas kernel (``_split_bf16`` :125-130,
``_real_fft_classes`` :147-211, ``_needed_complex_k1`` :214-227 and the
constants of :596-760). The factorization, with N = 128·r:

    x[n₁ + 128·n₂]                                   (n₂ = chunk, n₁ minor)
    Y[c, n₁]  = Σ_{n₂} x[n₂, n₁] · W_r^{n₂ c}          inner r-point DFT
    B[c, n₁]  = W_N^{n₁ c} · Y[c, n₁]                  twiddle
    X[c+r·k₁] = Σ_{n₁} B[c, n₁] · W₁₂₈^{n₁ k₁}         outer 128-point DFT

Only classes c = 0..r/2 are computed (Hermitian symmetry): slot (c, k₁) with
c > r/2 mirrors to (r−c, 127−k₁), and the mapping is folded on the host so
that its rows read the (c, k₁) layout directly. Classes 0 and r/2 are real
after the inner DFT; their twiddle is folded into their outer constant.

Everything here is numpy (f64, cast at the edge) except the bf16 rounding,
which uses torch's round-to-nearest-even conversion.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "split_bf16",
    "bf16_bits",
    "real_fft_classes",
    "needed_complex_k1",
    "outer_constants",
    "class_twiddles",
    "fold_mapping",
    "mma_b_fragments",
]


def _round_bf16(a32: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a32)).to(torch.bfloat16).float().numpy()


def split_bf16(a):
    """f32 → (hi, lo), both bf16 values held in f32 arrays, a ≈ hi + lo.

    hi = bf16(a), lo = bf16(a − hi), each rounded to nearest even.
    """
    a32 = np.asarray(a, dtype=np.float64).astype(np.float32)
    hi = _round_bf16(a32)
    lo = _round_bf16(a32 - hi)
    return hi, lo


def bf16_bits(a) -> np.ndarray:
    """The uint16 bit patterns of bf16 values held in an f32 array (exact)."""
    a32 = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    bits = (a32.view(np.uint32) >> 16).astype(np.uint16)
    if not np.array_equal((bits.astype(np.uint32) << 16).view(np.float32), a32):
        raise ValueError("bf16_bits takes values that are already bf16")
    return bits


def real_fft_classes(xs):
    """Shared radix-2 DIT real-input DFT over the chunk axis.

    ``xs``: list of ``r`` real arrays (torch or numpy, same shape). Returns
    ``(re, im)`` for classes c = 0..r/2 of ``Y[c] = Σ_{n₂} xs[n₂]·e^{-2πi n₂ c/r}``,
    with ``im=None`` meaning exactly zero (classes 0 and r/2). The same
    recursion, operation for operation, as the JAX package's, so the f32
    values agree with its kernel's.
    """
    r = len(xs)
    if r == 1:
        return [(xs[0], None)]
    ev = real_fft_classes(xs[0::2])
    od = real_fft_classes(xs[1::2])
    half = r // 2

    def mul(x, s):
        if x is None or abs(s) < 1e-15:
            return None
        if s == 1.0:
            return x
        if s == -1.0:
            return -x
        return x * float(np.float32(s))

    def add(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    def sub_dft(dfts, c):
        if c <= half // 2:
            return dfts[c]
        re, im = dfts[half - c]
        return re, (None if im is None else -im)

    out = []
    for c in range(r // 2 + 1):
        e_re, e_im = sub_dft(ev, c % half)
        o_re, o_im = sub_dft(od, c % half)
        wr = float(np.cos(2.0 * np.pi * c / r))
        wi = float(-np.sin(2.0 * np.pi * c / r))
        if abs(wr) < 1e-15:
            wr = 0.0
        if abs(wi) < 1e-15:
            wi = 0.0
        for exact in (-1.0, 1.0):
            if abs(wr - exact) < 1e-15:
                wr = exact
            if abs(wi - exact) < 1e-15:
                wi = exact
        t_re = add(mul(o_re, wr), mul(o_im, -wi))
        t_im = add(mul(o_im, wr), mul(o_re, wi))
        out.append((add(e_re, t_re), add(e_im, t_im)))
    return out


def needed_complex_k1(fb: np.ndarray, r: int):
    """Sorted k₁ values any complex class reads, given the mapping's nonzero
    columns (mirrored slots included); None when more than 64 are read."""
    ks = set()
    for k in np.nonzero(np.any(fb != 0.0, axis=0))[0]:
        c, k1 = int(k) % r, int(k) // r
        if c > r // 2:
            c, k1 = r - c, 127 - k1
        if 0 < c < r // 2:
            ks.add(k1)
        if len(ks) > 64:
            return None
    return sorted(ks)


def outer_constants(n_fft: int, gauss: bool):
    """(rw, G) f64 outer-DFT constants.

    ``rw`` (256, 256): rows ``slot·128 + n₁`` for the real classes 0 and r/2,
    columns ``[cos θ | −sin θ]`` with the class twiddle folded into θ.
    ``G``: the packed complex constant ``[[C, −S'], [S', C]]`` (256, 256) for
    input ``[re | im]``, or with ``gauss`` the three Gauss constants
    ``[C | C−S' | −(C+S')]`` (128, 384): T1=(a+b)@G1, T2=b@G2, T3=a@G3,
    re = T1−T2, im = T1+T3.
    """
    r = n_fft // 128
    n1 = np.arange(128, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n1, n1) / 128.0
    C, Sp = np.cos(ang), np.sin(ang)
    if gauss:
        G = np.concatenate([C, C - Sp, -(C + Sp)], axis=1)
    else:
        G = np.block([[C, -Sp], [Sp, C]])
    rw = np.zeros((256, 256), dtype=np.float64)
    for slot, c in enumerate((0, r // 2)):
        th = ang + 2.0 * np.pi * np.outer(n1, np.ones(128)) * c / n_fft
        rw[slot * 128:(slot + 1) * 128, :128] = np.cos(th)
        rw[slot * 128:(slot + 1) * 128, 128:] = -np.sin(th)
    return rw, G


def class_twiddles(n_fft: int) -> np.ndarray:
    """(classes, 256) f32 twiddles ``[cos | −sin](2π n₁ c / N)`` per class."""
    classes = n_fft // 256 + 1
    th = 2.0 * np.pi * np.outer(np.arange(classes), np.arange(128)) / n_fft
    return np.concatenate([np.cos(th), -np.sin(th)], axis=1).astype(np.float32)


def fold_mapping(fb: np.ndarray, n_fft: int) -> np.ndarray:
    """(n_out, n_bins) mapping → (classes·128, n_out) f64 in the (c, k₁) layout.

    Natural bin k sits at slot (k mod r, k // r); a slot with c > r/2 is
    mirrored to (r−c, 127−k₁), which holds the same power.
    """
    r = n_fft // 128
    k = np.arange(fb.shape[1])
    c, k1 = k % r, k // r
    mirror = c > r // 2
    c = np.where(mirror, r - c, c)
    k1 = np.where(mirror, 127 - k1, k1)
    M = np.zeros(((r // 2 + 1) * 128, fb.shape[0]), dtype=np.float64)
    np.add.at(M, c * 128 + k1, np.asarray(fb, dtype=np.float64).T)
    return M


def mma_b_fragments(b: np.ndarray) -> np.ndarray:
    """bf16 values (K, N) → uint16 (K/16, N/8, 32, 4): the B operand of
    ``mma.m16n8k16.row.col`` in the order the kernel loads it.

    Lane l = 4·g + t of the warp holds, for k-step ``ks`` and n-tile ``nt``,
    ``b0 = (B[16ks+2t, 8nt+g], B[16ks+2t+1, 8nt+g])`` and
    ``b1 = (B[16ks+2t+8, 8nt+g], B[16ks+2t+9, 8nt+g])``, the lower k in the
    lower half of each 32-bit register: one 8-byte load per lane. K must be
    a multiple of 16 and N of 8 (pad with zeros first).
    """
    K, N = b.shape
    if K % 16 or N % 8:
        raise ValueError(f"B is {K}x{N}; K must be a multiple of 16 and N of 8")
    bits = bf16_bits(b)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    ks = np.arange(K // 16)[:, None, None, None]
    nt = np.arange(N // 8)[None, :, None, None]
    kk = 16 * ks + 2 * t[None, None, :, None] + np.array([0, 1, 8, 9])[None, None, None, :]
    nn = 8 * nt + g[None, None, :, None]
    return np.ascontiguousarray(bits[kk, nn])
