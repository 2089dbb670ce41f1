"""Host layout of the f32 fused kernel (``csrc/fused_features.cu``), and its
plain PyTorch twin.

The kernel computes an n_fft-point real DFT as an M = n_fft/2-point complex
FFT of the even/odd-packed frame, z[m] = x[2m] + i·x[2m+1], followed by one
split pass. The complex FFT is a Stockham autosort FFT in registers: each
thread holds 8 points of a frame and runs one radix-2/4 pass (when log2 M is
not a multiple of 3) and then radix-8 passes, exchanging through shared
memory between passes. This module builds what the kernel reads, in f64
then cast:

- ``twiddle_table``: the twiddles of every pass after the first, in the
  order the kernel walks them (per pass: r = 1..R-1 major, k = 0..Ns-1
  minor, so neighbouring threads read neighbouring entries), then the split
  twiddles W_N^k for k = 0..M/2;
- ``band_pieces``: each mapping row's nonzero band cut into pieces of at most
  ``PIECE`` bins, with the band's weights packed contiguously, so that the
  filterbank is spread over the block by nonzeros, not by rows
  (``kernel_pieces`` lengthens the pieces of a dense mapping);
- ``smem_layout`` and ``tile_frames``: the block's shared memory and tile.

``fused_features_twin`` runs the kernel's own decomposition step by step in
f32 (signal span, packing, radix passes, split, pieces); the tests hold it
against ``torch.fft.rfft``, ``fused_features_reference`` and the JAX kernel.
No plan calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidInputError
from .framing import frame_count

__all__ = [
    "PIECE",
    "MAX_THREADS",
    "BLOCK_THREADS",
    "MAX_SMEM",
    "radix_plan",
    "twiddle_offsets",
    "twiddle_table",
    "band_pieces",
    "kernel_pieces",
    "span_floats",
    "smem_layout",
    "tile_frames",
    "stage_span",
    "stockham_fft",
    "real_split",
    "banded_rows",
    "fused_features_twin",
]

PIECE = 8            # bins per filterbank work item
MAX_THREADS = 512    # threads per block: tile_f frames x M/8 threads each
BLOCK_THREADS = 256  # the block size the tile aims at
MAX_SMEM = 232448    # dynamic shared memory a block may use on sm_90


def radix_plan(m: int) -> list:
    """Radices of the M-point FFT's passes: 2 or 4 first where log2 M is not
    a multiple of 3, then 8s (128 → [2, 8, 8], 512 → [8, 8, 8])."""
    log2m = m.bit_length() - 1
    first = 1 << (log2m % 3)
    return ([first] if first > 1 else []) + [8] * (log2m // 3)


def twiddle_offsets(m: int) -> tuple:
    """({Ns: offset} of each pass after the first, offset of the split
    twiddles, table length)."""
    offs, at, ns = {}, 0, 1
    for r in radix_plan(m):
        if ns > 1:
            offs[ns] = at
            at += (r - 1) * ns
        ns *= r
    return offs, at, at + m // 2 + 1


def twiddle_table(n_fft: int) -> np.ndarray:
    """(entries, 2) f64 [cos, sin] of the kernel's twiddles (see the module
    note): W_{Ns·R}^{k·r} per pass, then W_N^k, k = 0..M/2; W_L = e^{-2πi/L}."""
    m = n_fft // 2
    offs, split, total = twiddle_offsets(m)
    ang = np.zeros(total)
    ns = 1
    for r in radix_plan(m):
        if ns > 1:
            k = np.arange(ns)
            for rr in range(1, r):
                ang[offs[ns] + (rr - 1) * ns + k] = -2.0 * np.pi * k * rr / (ns * r)
        ns *= r
    ang[split:] = -2.0 * np.pi * np.arange(m // 2 + 1) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1)


def band_pieces(fb: np.ndarray, piece: int = PIECE) -> tuple:
    """The filterbank by nonzeros: (items (n_items, 4) int32 rows of
    [first bin, bins, weight offset, 0], first (n_out + 1) int32 item of
    each row, weights f64). Row m sums items first[m]..first[m+1]-1, which
    cover its band [lo, hi) of ``mapping_bands`` (zeros inside the band
    included, so the sum equals the old per-band loop's); an all-zero row
    has no item and sums to 0."""
    items, first, weights = [], [0], []
    for row in np.asarray(fb, dtype=np.float64):
        nz = np.flatnonzero(row)
        if nz.size:
            lo, hi = int(nz[0]), int(nz[-1]) + 1
            for a in range(lo, hi, piece):
                cnt = min(piece, hi - a)
                items.append((a, cnt, len(weights), 0))
                weights.extend(row[a:a + cnt])
        first.append(len(items))
    return (np.asarray(items, dtype=np.int32).reshape(-1, 4),
            np.asarray(first, dtype=np.int32), np.asarray(weights, dtype=np.float64))


def kernel_pieces(fb: np.ndarray) -> tuple:
    """``band_pieces`` as the kernel runs them: ``PIECE`` bins, doubled until
    a frame's partial sums fit in the FFT buffer they reuse (2·(M + M/16)
    floats), so that a dense mapping (ERB, 65,664 nonzeros at 1024) does not
    take the shared memory of the block's frames."""
    n_bins = fb.shape[1]
    room = 2 * ((n_bins - 1) + (n_bins - 1) // 16)
    piece = PIECE
    while True:
        items, first, weights = band_pieces(fb, piece)
        if len(items) <= room or piece >= n_bins:
            return items, first, weights
        piece *= 2


def span_floats(tile_f: int, n_fft: int, hop: int) -> int:
    """Floats of the staged signal span: the tile's (tile_f-1)·hop + n_fft
    samples, shifted by up to 3 to a 16-byte boundary, in whole 16-byte
    chunks."""
    return 4 * (((tile_f - 1) * hop + n_fft + 6) // 4)


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def smem_layout(tile_f: int, n_fft: int, hop: int, n_items: int, n_out: int,
                with_dct: bool) -> tuple:
    """(buf_off, bytes): the float offset of the FFT buffer and the block's
    dynamic shared memory.

    Region 1 (offset 0) holds the signal span, then the power rows
    (stride M + 1), then the DCT's input (stride n_out + 1). Region 2 holds
    the FFT buffer (per frame M complex values, padded by one in 16),
    then the filterbank's partial sums. The twiddle table is not staged: the
    kernel reads it through L1, where it stays across the SM's blocks.
    """
    m = n_fft // 2
    r1 = max(span_floats(tile_f, n_fft, hop), tile_f * (m + 1),
             tile_f * (n_out + 1) if with_dct else 0)
    r2 = max(tile_f * 2 * (m + m // 16), tile_f * n_items)
    buf_off = _round4(r1)
    return buf_off, 4 * (buf_off + r2)


def tile_frames(n_fft: int, hop: int, n_items: int, n_out: int, with_dct: bool) -> int:
    """Frames per block (M/8 threads a frame), a power of two:
    ``BLOCK_THREADS`` worth, and at least two, fewer where shared memory
    runs out. 256-thread blocks
    measured fastest at the flagship (4 frames); at n_fft 4096 one frame a
    block stages five times its own samples, and measured a quarter slower
    than two."""
    tile = max(2, BLOCK_THREADS // (n_fft // 16))
    while tile > 1 and smem_layout(tile, n_fft, hop, n_items, n_out, with_dct)[1] > MAX_SMEM:
        tile //= 2
    if smem_layout(tile, n_fft, hop, n_items, n_out, with_dct)[1] > MAX_SMEM:
        raise InvalidInputError(
            f"n_out={n_out} leaves no room in shared memory for the fused kernel"
        )
    return tile


# ---- the plain twin of the kernel's decomposition --------------------------

def stage_span(row: torch.Tensor, s0: int, length: int, address: int = 0) -> tuple:
    """(sh, span) as a block stages it: ``row`` (n,) f32; the span starts at
    sample ``s0`` (negative under centre padding), shifted down by sh in
    0..3 so that its first chunk sits on a 16-byte boundary, for a row whose
    first sample lies at float ``address`` of memory. Whole 4-sample chunks,
    samples outside the row zero."""
    n = row.shape[-1]
    sh = (address + s0) % 4
    chunks = (sh + length + 3) // 4
    idx = torch.arange(s0 - sh, s0 - sh + 4 * chunks)
    valid = (idx >= 0) & (idx < n)
    return sh, torch.where(valid, row[idx.clamp(0, n - 1)], torch.zeros((), dtype=row.dtype))


def _dft_matrix(r: int) -> torch.Tensor:
    k = np.arange(r)
    return torch.from_numpy(np.exp(-2j * np.pi * np.outer(k, k) / r).astype(np.complex64))


def stockham_fft(z: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The kernel's M-point complex FFT of z (..., M) complex64, pass by
    pass: item j of a radix-R pass reads j + r·M/R, scales by W_{Ns·R}^{k·r}
    (k = j mod Ns, from ``table``, (entries, 2) f32), runs an R-point DFT and
    writes (j - k)·R + k + r·Ns. Natural order in and out."""
    m = z.shape[-1]
    tw = torch.complex(table[:, 0], table[:, 1])
    offs = twiddle_offsets(m)[0]
    ns = 1
    for r in radix_plan(m):
        j = torch.arange(m // r)
        rr = torch.arange(r)
        v = z[..., j[:, None] + rr[None, :] * (m // r)]         # (..., M/R, R)
        k = j % ns
        if ns > 1:
            w = tw[offs[ns] + (rr[None, 1:] - 1) * ns + k[:, None]]
            v = torch.cat([v[..., :1], v[..., 1:] * w], dim=-1)
        v = v @ _dft_matrix(r)
        out = torch.empty_like(z)
        out[..., ((j - k) * r + k)[:, None] + rr[None, :] * ns] = v
        z, ns = out, ns * r
    return z


def real_split(zf: torch.Tensor, table: torch.Tensor, n_fft: int) -> torch.Tensor:
    """X[0..M] of the real frame from Z = FFT(z), as the kernel splits it:
    Xe = (Z[k] + conj Z[M-k])/2, Xo = (Z[k] - conj Z[M-k])/2i, t = W_N^k·Xo;
    X[k] = Xe + t and X[M-k] = conj(Xe - t), k = 0..M/2."""
    m = n_fft // 2
    split = twiddle_offsets(m)[1]
    k = torch.arange(m // 2 + 1)
    w = torch.complex(table[split:split + m // 2 + 1, 0], table[split:split + m // 2 + 1, 1])
    zk, zc = zf[..., k], torch.conj(zf[..., (m - k) % m])
    xe = 0.5 * (zk + zc)
    d = zk - zc
    xo = torch.complex(0.5 * d.imag, -0.5 * d.real)
    t = w * xo
    out = torch.empty(zf.shape[:-1] + (m + 1,), dtype=zf.dtype)
    out[..., m - k] = torch.conj(xe - t)
    out[..., k] = xe + t
    return out


def banded_rows(p: torch.Tensor, items, first, weights) -> torch.Tensor:
    """(..., n_bins) → (..., n_out): each item's partial sum over its bins,
    then each row's items summed in order, as the kernel does."""
    items = torch.as_tensor(items, dtype=torch.int64)
    q = torch.arange(int(items[:, 1].max()) if len(items) else 1)
    live = q[None, :] < items[:, 1:2]
    w = torch.cat([torch.as_tensor(weights, dtype=torch.float32), torch.zeros(1)])
    bins = torch.where(live, items[:, :1] + q[None, :], 0)
    wgt = w[torch.where(live, items[:, 2:3] + q[None, :], len(w) - 1)]
    partial = (p[..., bins] * wgt).sum(-1)                       # (..., n_items)
    first = [int(v) for v in first]
    cols = [partial[..., a:e].sum(-1) if e > a else torch.zeros(p.shape[:-1])
            for a, e in zip(first[:-1], first[1:])]
    return torch.stack(cols, dim=-1)


def fused_features_twin(x, window, fb, amp, floor_db, pre_amp, dct, centre, n_fft, hop,
                        tile_f=None, address=0):
    """The kernel's decomposition in f32 on the CPU: (batch, n) →
    (batch, n_out | n_coef, n_frames). ``window`` (n_fft,), ``fb`` (n_out,
    n_bins) and ``dct`` (n_out, n_coef) or None are numpy; ``address`` is
    the float offset in memory of row 0's first sample (rows follow at
    stride n), which sets each span's shift."""
    x = torch.as_tensor(x, dtype=torch.float32)
    batch, n = x.shape
    m = n_fft // 2
    pad = m if centre else 0
    nf = frame_count(n, n_fft, hop, centre)
    items, first, weights = kernel_pieces(fb)
    tile_f = tile_f or tile_frames(n_fft, hop, len(items), fb.shape[0], dct is not None)
    table = torch.tensor(twiddle_table(n_fft), dtype=torch.float32)
    win = torch.tensor(window, dtype=torch.float32)
    span_len = (tile_f - 1) * hop + n_fft
    frames = torch.empty(batch, -(-nf // tile_f) * tile_f, n_fft)
    for b in range(batch):
        for f0 in range(0, nf, tile_f):
            sh, span = stage_span(x[b], f0 * hop - pad, span_len, address + b * n)
            idx = sh + torch.arange(tile_f)[:, None] * hop + torch.arange(n_fft)[None, :]
            frames[b, f0:f0 + tile_f] = span[idx]
    frames = frames[:, :nf]
    z = torch.complex(frames[..., 0::2] * win[0::2], frames[..., 1::2] * win[1::2])
    spec = real_split(stockham_fft(z, table), table, n_fft)
    p = spec.real * spec.real + spec.imag * spec.imag
    if pre_amp == "magnitude":
        p = torch.sqrt(p)
    feat = banded_rows(p, items, first, weights)
    if amp == "magnitude":
        feat = torch.sqrt(feat)
    elif amp == "decibels":
        feat = 10.0 * torch.log10(torch.clamp_min(feat, 10.0 ** (floor_db / 10.0)))
    if dct is not None:
        feat = feat @ torch.tensor(dct, dtype=torch.float32)
    return feat.transpose(-1, -2).contiguous()
