"""Host layout of the tier kernel (``csrc/fused_tier_features.cu``), and its
plain PyTorch twin.

The tier kernel computes the TPU kernel's factorization (``factored_layout``)
at the bf16 tiers. Per block of ``tile_f`` frames of one signal it stages the
tile's signal span once, runs the inner r-point DFT of every (n₁, frame) as a
radix-2 real FFT in registers (the DIT order of
``factored_layout.real_fft_classes``, with the same zero and ±1 shortcuts, so
its f32 values are the plain version's), rounds the twiddled classes to bf16
into A, and runs the outer 128-point DFT, the filterbank and the DCT as
``mma.sync`` products. It computes only what a mapping row reads. This module
builds, in f64 then cast:

- ``class_ntiles``: per class c = 0..r/2, the outer n-tiles (8 k₁ columns
  each, 16 a class) that any folded-mapping row reads; every other power
  entry is never computed, written or read (exact: a zero weight times a
  finite power adds 0);
- ``power_slots`` and ``compact_mapping``: the power tile P holds only those
  n-tiles, in slot order, and the folded mapping keeps only their rows;
- ``sparse_ksteps`` and ``packed_fragments``: for each 8-column n-tile of the
  compact mapping, the 16-row k-steps that hold a nonzero, with their mma B
  fragments packed in list order;
- ``outer_items``: the warps' work list of the outer DFT, one item per
  n-tile of a real class or of a group's complex classes, with a mask of
  the row tiles that read it; n-tile major, so that neighbouring warps share
  B fragments;
- ``tier_layout``: the tile, the class groups and the shared memory.

``tier_twin`` runs the kernel's decomposition step by step on the CPU in f32;
the tests hold it against ``fused_tier_features_reference`` and the JAX
kernel. No plan calls it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import InvalidInputError
from . import f32_layout as fl32
from . import factored_layout as fl
from .framing import frame_count

__all__ = [
    "MAX_SMEM",
    "SM_SMEM",
    "TILES",
    "dft_twiddles",
    "inner_fft_classes",
    "class_ntiles",
    "power_slots",
    "compact_mapping",
    "sparse_ksteps",
    "packed_fragments",
    "outer_items",
    "TierLayout",
    "tier_layout",
    "block_threads",
    "tier_twin",
]

MAX_SMEM = fl32.MAX_SMEM   # dynamic shared memory a block may use on sm_90
SM_SMEM = 233472           # an SM's shared memory; each resident block reserves 1 KB
TILES = (16, 8)            # frames per block, in order of preference
KIND_REAL0, KIND_REAL_HALF, KIND_COMPLEX = 0, 1, 2


def dft_twiddles() -> tuple:
    """(cos, sin) f32 of 2πk/32, k = 0..16: every W_s^c of the inner DFT's
    levels (s ≤ 32) is W_32^(c·32/s), bit for bit as ``real_fft_classes``
    rounds ``np.cos(2πc/s)`` to f32. The kernel holds the same values as
    literals."""
    k = np.arange(17, dtype=np.float64)
    return (np.cos(2.0 * np.pi * k / 32).astype(np.float32),
            np.sin(2.0 * np.pi * k / 32).astype(np.float32))


def _w_kinds(s: int, c: int) -> tuple:
    """Compile-time kinds of (cos, −sin)(2πc/s): 0 zero, 1 one, 2 minus one,
    3 a general value (``real_fft_classes`` snaps the first three)."""
    kr = 0 if 4 * c == s else 1 if c == 0 else 2 if 2 * c == s else 3
    ki = 0 if c == 0 or 2 * c == s else 2 if 4 * c == s else 3
    return kr, ki


def inner_fft_classes(xs):
    """The kernel's inner DFT: ``real_fft_classes`` over the r chunks ``xs``
    (f32 tensors), written as the kernel's template recursion, each twiddle
    from the f32 table of ``dft_twiddles``. Returns [(re, im)] for classes
    0..r/2, im None where exactly zero."""
    cos, sin = (torch.from_numpy(t) for t in dft_twiddles())
    r = len(xs)

    def wmul(x, kind, w):
        if x is None or kind == 0:
            return None
        return x if kind == 1 else -x if kind == 2 else x * w

    def add(a, b):
        return b if a is None else a if b is None else a + b

    def level(idx):
        s = len(idx)
        if s == 1:
            return [(xs[idx[0]], None)]
        ev, od, h = level(idx[0::2]), level(idx[1::2]), s // 2
        out = []
        for c in range(s // 2 + 1):
            ce = c % h
            if ce <= h // 2:
                (e_re, e_im), (o_re, o_im) = ev[ce], od[ce]
            else:
                (e_re, e_im), (o_re, o_im) = ev[h - ce], od[h - ce]
                e_im = None if e_im is None else -e_im
                o_im = None if o_im is None else -o_im
            kr, ki = _w_kinds(s, c)
            k = c * 32 // s
            nki = {0: 0, 2: 1, 3: 3}[ki]          # kind of −wi
            t_re = add(wmul(o_re, kr, cos[k]), wmul(o_im, nki, sin[k]))
            t_im = add(wmul(o_im, kr, cos[k]), wmul(o_re, ki, -sin[k]))
            out.append((add(e_re, t_re), add(e_im, t_im)))
        return out

    return level(list(range(r)))


# ---- what the mapping reads --------------------------------------------------

def class_ntiles(fb: np.ndarray, n_fft: int) -> list:
    """Per class c = 0..r/2, the sorted outer n-tiles j (k₁ in 8j..8j+7)
    that a row of the folded mapping reads."""
    r = n_fft // 128
    read = np.any(fl.fold_mapping(fb, n_fft) != 0.0, axis=1).reshape(r // 2 + 1, 16, 8)
    return [tuple(int(j) for j in np.flatnonzero(read[c].any(axis=1))) for c in range(r // 2 + 1)]


def power_slots(ntiles) -> tuple:
    """((classes, 16) int32 slot of each (class, n-tile) in the compact power
    tile, −1 where not read; kc, its columns: 8 a slot, a multiple of 16,
    at least 16)."""
    slots = np.full((len(ntiles), 16), -1, dtype=np.int32)
    n = 0
    for c, js in enumerate(ntiles):
        for j in js:
            slots[c, j] = n
            n += 1
    return slots, max(16, -(-8 * n // 16) * 16)


def compact_mapping(fb: np.ndarray, n_fft: int, ntiles) -> np.ndarray:
    """(kc, n_out) f64: the folded mapping's rows of the compact power tile,
    slot s holding rows c·128 + 8j + (0..7); padding rows zero."""
    fold = fl.fold_mapping(fb, n_fft)
    slots, kc = power_slots(ntiles)
    out = np.zeros((kc, fold.shape[1]), dtype=np.float64)
    for c, js in enumerate(ntiles):
        for j in js:
            s = slots[c, j]
            out[8 * s:8 * s + 8] = fold[c * 128 + 8 * j:c * 128 + 8 * j + 8]
    return out


def sparse_ksteps(m: np.ndarray) -> tuple:
    """(first (n_tiles + 1,) int32, ks int32): for each 8-column n-tile of
    ``m`` (K, N; K a multiple of 16, N of 8), the 16-row k-steps with a
    nonzero, entries first[nt]..first[nt+1]-1 of ``ks``."""
    K, N = m.shape
    nz = (np.asarray(m, np.float32) != 0).reshape(K // 16, 16, N // 8, 8).any(axis=(1, 3))
    first, ks = [0], []
    for nt in range(N // 8):
        ks.extend(int(k) for k in np.flatnonzero(nz[:, nt]))
        first.append(len(ks))
    return np.asarray(first, dtype=np.int32), np.asarray(ks, dtype=np.int32)


def packed_fragments(b: np.ndarray, first: np.ndarray, ks: np.ndarray) -> np.ndarray:
    """bf16 values (K, N) → uint16 (entries, 32, 4): the mma B fragments of
    the listed (k-step, n-tile) pairs, in list order (``mma_b_fragments``'
    lane layout). At least one entry, so that the buffer exists."""
    frag = fl.mma_b_fragments(b)                     # (K/16, N/8, 32, 4)
    nt = np.repeat(np.arange(len(first) - 1), np.diff(first))
    out = frag[ks, nt] if len(ks) else np.zeros((1, 32, 4), np.uint16)
    return np.ascontiguousarray(out)


def outer_items(ntiles, groups, tile_f: int, warps: int = 8) -> tuple:
    """(items (n, 4) int32, group_first (groups + 1,) int32): the outer DFT's
    work. An item is one n-tile j of class 0 (kind 0), of class r/2 (kind 1)
    or of a group's complex classes (kind 2): (kind | j << 2, mask, 0, 0),
    the mask's bit u set where the item runs row tile u of its A region. A's
    rows are (class, frame) flattened, ``tile_f`` frames a class, so a
    16-row tile holds one class, or two at 8 frames. A complex n-tile's row
    tiles are split over items of at most 4, 2 or 1 tiles, the most that
    still gives each of the block's ``warps`` two items (a warp loads an
    item's B fragments once). The real classes go with the first group;
    within a group, n-tile major, so that neighbouring warps read the same
    B fragments."""
    half = len(ntiles) - 1
    real_mask = (1 << (max(tile_f, 16) // 16)) - 1
    masks = []                                    # per group: [(j, row-tile mask)]
    for c0, c1 in groups:
        n_tiles = -(-(c1 - c0) * tile_f // 16)
        if n_tiles > 32:
            raise InvalidInputError(f"a class group of {n_tiles} row tiles exceeds 32")
        row = []
        for j in range(16):
            mask = 0
            for u in range(n_tiles):
                lo, hi = c0 + 16 * u // tile_f, min(c0 + (16 * u + 15) // tile_f, c1 - 1)
                if any(j in ntiles[c] for c in range(lo, hi + 1)):
                    mask |= 1 << u
            row.append((j, mask))
        masks.append(row)

    def split(mask, size):
        bits = [u for u in range(32) if mask >> u & 1]
        return [sum(1 << u for u in bits[i:i + size]) for i in range(0, len(bits), size)]

    n_real = sum(len(ntiles[0]) + len(ntiles[half]) for _ in groups[:1])
    size = 4
    while size > 1 and n_real + sum(len(split(m, size)) for row in masks
                                    for _, m in row) < 2 * warps:
        size //= 2
    items, first = [], [0]
    for g, row in enumerate(masks):
        for j, mask in row:
            if g == 0:
                for kind, c in ((KIND_REAL0, 0), (KIND_REAL_HALF, half)):
                    if j in ntiles[c]:
                        items.append((kind | j << 2, real_mask, 0, 0))
            items.extend((KIND_COMPLEX | j << 2, m, 0, 0) for m in split(mask, size))
        first.append(len(items))
    items = np.asarray(items, dtype=np.int64).reshape(-1, 4)
    return items.astype(np.uint32).view(np.int32), np.asarray(first, dtype=np.int32)


# ---- tile, groups, shared memory ----------------------------------------------

def block_threads(n_fft: int) -> int:
    """Threads a block: 256, and 512 at n_fft ≥ 2048, whose blocks are alone
    on their SM (their shared memory)."""
    return 512 if n_fft >= 2048 else 256


def _align(v: int) -> int:
    return -(-v // 16) * 16


@dataclass(frozen=True)
class TierLayout:
    """The kernel's block: ``tile_f`` frames; complex classes in ``groups``
    ([c0, c1) each, the inner FFT run once a group); ``staged``: the signal
    span is in shared memory at offset 0 (else samples are read through
    L1); byte offsets of the other regions and the total ``smem``; and
    ``blocks``, the blocks an SM's shared memory holds."""

    tile_f: int
    groups: tuple
    staged: bool
    p_off: int
    feat_off: int
    ar_off: int
    ac_off: int
    smem: int

    @property
    def blocks(self) -> int:
        return SM_SMEM // (self.smem + 1024)


def _lda(n_fft: int, gauss: bool) -> int:
    return 136 if n_fft == 256 else (392 if gauss else 264)


def _layout(tile_f, n_fft, hop, gauss, x2, kc, kd, group, staged) -> TierLayout:
    r = n_fft // 128
    n_cplx = max(r // 2 - 1, 0)
    words = 2 if x2 else 1
    span = 4 * fl32.span_floats(tile_f, n_fft, hop) if staged else 0
    rf = max(tile_f, 16)              # rows of P, the DCT input and a real slot
    p = rf * (kc + 8) * 2 * words
    feat = rf * (kd + 8) * 2 * words if kd else 0
    a_real = 2 * rf * 136 * 2
    a_cplx = -(-min(group, n_cplx) * tile_f // 16) * 16 * _lda(n_fft, gauss) * 2
    groups = tuple((c, min(c + group, r // 2)) for c in range(1, r // 2, group)) or ((1, 1),)
    if len(groups) == 1:
        # the span is dead once A is written: P and the DCT input reuse it
        front = max(_align(span), _align(p) + _align(feat))
        p_off, feat_off = 0, _align(p)
    else:
        front = _align(span) + _align(p) + _align(feat)
        p_off, feat_off = _align(span), _align(span) + _align(p)
    ar_off = front
    ac_off = ar_off + _align(a_real)
    return TierLayout(tile_f, groups, staged, p_off, feat_off, ar_off, ac_off,
                      ac_off + _align(a_cplx))


def tier_layout(n_fft: int, hop: int, gauss: bool, x2: bool, kc: int, kd: int,
                tile_f: int = None) -> TierLayout:
    """The block for a request: ``kc`` compact power columns, ``kd`` DCT
    rows (0: no DCT). For a tile, the fewest class groups that fit, of even
    size (each group runs the inner FFT again), with the span staged where
    it fits (else, at large hops, samples are read through L1). The tile,
    unless given: the fewest groups, then a staged span, then the order of
    ``TILES`` (16 frames measured fastest at the flagship, 32 slower at
    every shape)."""
    tiles = TILES if tile_f is None else (tile_f,)
    if tile_f is not None and tile_f not in TILES:
        raise InvalidInputError(f"the tier kernel's tile is one of {TILES} frames, not {tile_f}")
    r = n_fft // 128
    n_cplx = max(r // 2 - 1, 1)
    found = []
    for rank, tile in enumerate(tiles):
        for staged in (True, False):
            lay = next((cand for n_groups in range(1, n_cplx + 1)
                        for cand in [_layout(tile, n_fft, hop, gauss, x2, kc, kd,
                                             -(-n_cplx // n_groups), staged)]
                        if cand.smem <= MAX_SMEM), None)
            if lay is not None:
                found.append(((len(lay.groups), not staged, rank), lay))
                break
    if not found:
        raise InvalidInputError(
            f"the tier kernel's block does not fit in shared memory (n_fft={n_fft}, "
            f"{kc} power columns, DCT over {kd} rows)"
        )
    return min(found, key=lambda e: e[0])[1]


# ---- the plain twin of the kernel's decomposition --------------------------------

def _bf16(a):
    return a.to(torch.bfloat16).to(torch.float32)


def _passes(a_hi, a_lo, b_hi, b_lo, passes):
    """Per pass one f32 sum, then (hh + hl) + lh, as the kernel's accumulators."""
    y = a_hi @ b_hi
    if passes > 1:
        y = y + a_hi @ b_lo
    if passes > 2:
        y = y + a_lo @ b_hi
    return y


def tier_twin(x, n_fft, hop, window, fb, dct, amp, floor_db, pre_amp, centre, precision,
              gauss, tile_f=16, address=0):
    """The tier kernel's decomposition in f32 on the CPU: (batch, n) →
    (batch, n_out | n_coef, n_frames). ``window`` (n_fft,), ``fb`` (n_out,
    n_bins) and ``dct`` (n_out, n_coef) or None are numpy (f64).

    Step by step as the kernel: spans staged per tile (``address`` is the
    float offset of row 0, which sets each span's shift); the in-register
    inner FFT; twiddle and one bf16 rounding of A; the outer products on the
    n-tiles a row reads only, into the compact power tile; the filterbank
    over its nonzero k-steps, in list order; amp; the DCT.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    batch, n = x.shape
    r = n_fft // 128
    x2 = precision == "bf16x2"
    outer, tail = (2, 3) if x2 else (1, 1)
    pad = n_fft // 2 if centre else 0
    nf = frame_count(n, n_fft, hop, centre)
    win = torch.tensor(window, dtype=torch.float32)
    span_len = (tile_f - 1) * hop + n_fft
    frames = torch.empty(batch, -(-nf // tile_f) * tile_f, n_fft)
    for b in range(batch):
        for f0 in range(0, nf, tile_f):
            sh, span = fl32.stage_span(x[b], f0 * hop - pad, span_len, address + b * n)
            idx = sh + torch.arange(tile_f)[:, None] * hop + torch.arange(n_fft)[None, :]
            frames[b, f0:f0 + tile_f] = span[idx]
    frames = frames[:, :nf] * win
    ys = inner_fft_classes([frames[..., 128 * q:128 * (q + 1)] for q in range(r)])

    ntiles = class_ntiles(fb, n_fft)
    slots, kc = power_slots(ntiles)
    rw, G = fl.outer_constants(n_fft, gauss)
    split = lambda a: tuple(torch.from_numpy(h) for h in fl.split_bf16(a))
    rw_hi, rw_lo = split(rw)
    g_hi, g_lo = split(G)
    tw = torch.from_numpy(fl.class_twiddles(n_fft))
    power = torch.zeros(batch, nf, kc)
    for c in range(r // 2 + 1):
        if not ntiles[c]:
            continue
        y_re, y_im = ys[c]
        if c in (0, r // 2):
            a = [_bf16(y_re)]
            rows = slice(0, 128) if c == 0 else slice(128, 256)
            b = [(rw_hi[rows], rw_lo[rows])]
        else:
            a_re = y_re * tw[c, :128] - y_im * tw[c, 128:]
            a_im = y_re * tw[c, 128:] + y_im * tw[c, :128]
            if gauss:
                a = [_bf16(a_re + a_im), _bf16(a_im), _bf16(a_re)]
                b = [(g_hi[:, 128 * q:128 * (q + 1)], g_lo[:, 128 * q:128 * (q + 1)])
                     for q in range(3)]
            else:
                a = [_bf16(torch.cat([a_re, a_im], dim=-1))]
                b = [(g_hi, g_lo)]
        for j in ntiles[c]:
            cj = list(range(8 * j, 8 * j + 8))
            if len(a) == 1:        # [re | im] columns of rw or the packed G
                re_c, im_c = cj, [128 + k for k in cj]
                re = _passes(a[0], None, b[0][0][:, re_c], b[0][1][:, re_c], outer)
                im = _passes(a[0], None, b[0][0][:, im_c], b[0][1][:, im_c], outer)
            else:
                t1, t2, t3 = (_passes(a[q], None, b[q][0][:, cj], b[q][1][:, cj], outer)
                              for q in range(3))
                re, im = t1 - t2, t1 + t3
            p = re * re + im * im
            power[..., 8 * slots[c, j]:8 * slots[c, j] + 8] = p
    if pre_amp == "magnitude":
        power = torch.sqrt(power)

    n_out = fb.shape[0]
    map_cols = -(-n_out // (16 if dct is not None else 8)) * (16 if dct is not None else 8)
    m = np.zeros((kc, map_cols))
    m[:, :n_out] = compact_mapping(fb, n_fft, ntiles)
    m_hi, m_lo = split(m)
    first, ks = sparse_ksteps(m)
    p_hi = _bf16(power)
    p_lo = _bf16(power - p_hi)
    feat = torch.zeros(batch, nf, map_cols)
    for nt in range(map_cols // 8):
        cols = slice(8 * nt, 8 * nt + 8)
        parts = [torch.zeros(batch, nf, 8) for _ in range(3)]
        for k in ks[first[nt]:first[nt + 1]]:
            rows = slice(16 * k, 16 * k + 16)
            parts[0] = parts[0] + p_hi[..., rows] @ m_hi[rows, cols]
            if tail > 1:
                parts[1] = parts[1] + p_hi[..., rows] @ m_lo[rows, cols]
                parts[2] = parts[2] + p_lo[..., rows] @ m_hi[rows, cols]
        feat[..., cols] = (parts[0] + parts[1]) + parts[2] if tail > 1 else parts[0]
    if amp == "magnitude":
        feat = torch.sqrt(feat)
    elif amp == "decibels":
        feat = 10.0 * torch.log10(torch.clamp_min(feat, 10.0 ** (floor_db / 10.0)))
    if dct is None:
        return feat[..., :n_out].transpose(-1, -2).contiguous()
    d = np.zeros((map_cols, dct.shape[1]))
    d[:n_out] = dct
    d_hi, d_lo = split(d)
    f_hi = _bf16(feat)
    out = _passes(f_hi, _bf16(feat - f_hi), d_hi, d_lo, tail)
    return out.transpose(-1, -2).contiguous()
