"""Constant-Q transform kernels, as real matrices (numpy).

Counterpart of ``spectrograms_tpu.ops.cqt``, a copy of its numpy builders
that must give the same arrays. Each bin's kernel is the reference's
(``cqt.rs:316-514``): length ⌈Q·sr/f_c⌋ clamped to the frame, a windowed
complex exponential, sparsity thresholding, unit-energy normalisation,
correlated against the frame's tail. All kernels are packed right-aligned
and zero-padded to the frame length into one real matrix pair, so the CQT is
two real matmuls per frame block:

    re = frames @ K_reᵀ,   im = frames @ K_imᵀ   (K conjugated)

The CQT consumes **unwindowed** frames: the kernels carry their own window
(the double-windowing trap, ``spectrogram.rs:1664``).

Beyond the dense kernels: the truncation policy (``resolve_cqt_policy``),
banded tail contraction (``plan_cqt_bands``, off unless
``set_cqt_banding(True)``) and the octave-stacked multirate groups
(``multirate_cqt_groups``) that restore full Q on 2^d-decimated copies of
the signal.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..errors import InvalidInputError
from ..params import CqtParams
from ..windows import make_window
from .decimate import HALFBAND_PASSBAND_FRAC

__all__ = [
    "cqt_kernel_matrices",
    "cqt_bin_frequencies",
    "resolve_cqt_policy",
    "truncation_q_loss",
    "TRUNCATION_Q_LOSS_THRESHOLD",
]


def _kernel_row(params: CqtParams, fc: float, sample_rate: float,
                frame_length: int):
    """One bin's right-aligned conjugate-correlation row pair (re, −im).

    Identical math to the reference's per-bin kernel generation
    (``cqt.rs:316-440``): length ⌈Q·sr/f_c⌋ clamped to the frame, windowed
    complex exponential, sparsity thresholding, unit-energy normalization.
    Returns (row_re, row_minus_im, was_truncated).
    """
    kernel_length = int(np.round(params.q_factor * sample_rate / fc))
    was_truncated = kernel_length > frame_length > 1
    kernel_length = max(1, min(kernel_length, frame_length))

    w = make_window(params.window, kernel_length, np.float64)
    t = np.arange(kernel_length, dtype=np.float64) / sample_rate
    phase = 2.0 * np.pi * fc * t
    kernel = (np.cos(phase) + 1j * np.sin(phase)) * w

    if params.sparsity_threshold > 0.0:
        mags = np.abs(kernel)
        max_mag = mags.max()
        if max_mag > 0.0:
            kernel = np.where(mags < max_mag * params.sparsity_threshold, 0.0, kernel)

    if params.normalize:
        energy = float(np.sum(np.abs(kernel) ** 2))
        if energy > 0.0:
            kernel = kernel / np.sqrt(energy)

    # Right-align: the reference correlates the kernel against the *end*
    # of the frame (start_idx = len - kernel_length, cqt.rs:497).
    row = np.zeros(frame_length, dtype=np.complex128)
    row[frame_length - kernel_length :] = kernel
    # Correlation uses conj(k): re += k.re·s, im += (-k.im)·s.
    return row.real, -row.imag, was_truncated


@lru_cache(maxsize=32)
def _cqt_kernels_cached(params: CqtParams, sample_rate: float, frame_length: int):
    num_bins = params.num_bins
    rows_re, rows_im, freqs = [], [], []
    truncated = []

    for bin_idx in range(num_bins):
        fc = params.bin_frequency(bin_idx)
        if fc >= sample_rate / 2.0:
            break  # reference stops generating bins at Nyquist
        row_re, row_mim, was_trunc = _kernel_row(params, fc, sample_rate, frame_length)
        if was_trunc:
            kernel_length = int(np.round(params.q_factor * sample_rate / fc))
            truncated.append((bin_idx, fc, kernel_length))
        rows_re.append(row_re)
        rows_im.append(row_mim)
        freqs.append(fc)

    if (
        truncated
        and not getattr(params, "multirate", False)
        and getattr(params, "truncate", None) is not True
    ):
        # The reference silently clamps kernels to the signal length
        # (cqt.rs:380-392); an integrated plan additionally clamps to n_fft.
        # A truncated kernel has less than its nominal Q — warn instead of
        # quietly degrading frequency resolution.
        # (With multirate=True these matrices are only the streaming
        # fallback; the octave-stacked path restores full Q and does its
        # own residual warning — multirate_cqt_groups.)
        import warnings

        lo_bin, lo_fc, lo_len = truncated[0]
        warnings.warn(
            f"{len(truncated)} low CQT bin(s) need kernels longer than the "
            f"frame ({lo_len} > {frame_length} samples at bin {lo_bin}, "
            f"{lo_fc:.1f} Hz) and are truncated, reducing their effective Q; "
            f"use n_fft >= {lo_len}, CqtParams(multirate=True), or a higher "
            "f_min / lower q_factor for full resolution",
            stacklevel=3,
        )
    k_re = np.asarray(rows_re, dtype=np.float64)
    k_im = np.asarray(rows_im, dtype=np.float64)
    f = np.asarray(freqs, dtype=np.float64)
    for a in (k_re, k_im, f):
        a.setflags(write=False)
    return k_re, k_im, f


# Correct-by-default policy (CqtParams.truncate): kernels losing
# more than this fraction of their effective Q to frame truncation flip the
# plan to the full-Q octave-stacked path. 1 %: below it the value error vs
# the untruncated ideal is within the multirate path's own anti-alias
# accuracy class (~2e-5/level), so the dense kernels are strictly cheaper.
TRUNCATION_Q_LOSS_THRESHOLD = 0.01


def truncation_q_loss(params: CqtParams, sample_rate: float,
                      frame_length: int) -> float:
    """Worst-case effective-Q loss fraction over the generated bins.

    A kernel of nominal length L clamped to F < L samples keeps only F/L
    of its Q (``cqt.rs:376-384`` does this silently);
    returns max(1 − F/L) over bins, 0.0 when every kernel fits.
    """
    worst = 0.0
    for bin_idx in range(params.num_bins):
        fc = params.bin_frequency(bin_idx)
        if fc >= sample_rate / 2.0:
            break
        nominal = int(np.round(params.q_factor * sample_rate / fc))
        if nominal > frame_length > 1:
            worst = max(worst, 1.0 - frame_length / nominal)
    return worst


def resolve_cqt_policy(params: CqtParams, sample_rate: float,
                       frame_length: int, hop: int, centre: bool) -> CqtParams:
    """Apply the ``CqtParams.truncate`` policy at plan-build time.

    Returns ``params`` unchanged, or with ``multirate=True, depth="max"``
    when the policy elects the full-Q octave-stacked path:

    - explicit ``multirate=True`` or ``truncate=True`` → unchanged;
    - ``truncate=None`` (auto) → multirate iff some kernel loses more than
      ``TRUNCATION_Q_LOSS_THRESHOLD`` of its Q *and* decimation alignment
      permits (otherwise the dense builder's warning stands);
    - ``truncate=False`` → multirate on any truncation at all (alignment
      permitting; the residual-truncation warning covers the rest).
    """
    if params.multirate or params.truncate is True:
        return params
    loss = truncation_q_loss(params, sample_rate, frame_length)
    threshold = TRUNCATION_Q_LOSS_THRESHOLD if params.truncate is None else 0.0
    if loss <= threshold:
        return params
    if max_decimation(frame_length, hop, centre) == 0:
        return params  # cannot decimate: dense fallback (builder warns)
    return params.with_multirate(True, depth="max")


def cqt_kernel_matrices(params: CqtParams, sample_rate: float, frame_length: int):
    """(K_re, K_im, freqs): (n_gen_bins, frame_length) real f64 matrices.

    ``frames @ K_re.T`` / ``frames @ K_im.T`` give the real/imag parts of the
    conjugate correlation of each kernel against the frame tail.
    """
    return _cqt_kernels_cached(params, float(sample_rate), int(frame_length))


def cqt_bin_frequencies(params: CqtParams, sample_rate: float) -> np.ndarray:
    """Center frequencies of the bins actually generated (below Nyquist)."""
    _, _, freqs = cqt_kernel_matrices(params, sample_rate, 1)
    return freqs


def cqt_kernel_lengths(params: CqtParams, sample_rate: float, frame_length: int) -> np.ndarray:
    """Clamped kernel length per generated bin (no kernel build)."""
    lengths = []
    for bin_idx in range(params.num_bins):
        fc = params.bin_frequency(bin_idx)
        if fc >= sample_rate / 2.0:
            break
        lengths.append(
            max(1, min(int(np.round(params.q_factor * sample_rate / fc)), frame_length))
        )
    return np.asarray(lengths, dtype=np.int64)


def _valid_support(s: int, n_fft: int, hop: int) -> bool:
    """Can (n_frames, s) tail-frames be extracted without a gather?

    Extraction slices the padded signal from the first tail onward, so only
    the hop/support divisibility matters (see ``framing.tail_framed_matmul``):
    ``s | hop`` gives strided row-slicing of one reshape, ``hop | s`` the
    hopped-slice decomposition; ``s == n_fft`` is the full-frame path.
    """
    return s == n_fft or hop % s == 0 or s % hop == 0


# Banded contraction default: OFF, as in the JAX package, where it measured
# slower than the dense single matmul (docs/KERNEL_AB.md): the dense CQT is
# bandwidth-bound, and per-band matmuls add signal reads, band padding and
# concatenation traffic. The machinery stays, tested exact, for MAC-bound
# regimes.
CQT_BANDING = False


def set_cqt_banding(enabled: bool) -> None:
    """Opt into banded tail contraction (see ``CQT_BANDING`` note)."""
    global CQT_BANDING
    CQT_BANDING = bool(enabled)


def plan_cqt_bands(lengths, n_fft: int, hop: int, max_bands: int = 4):
    """Partition bins into tail-aligned support bands of least matmul cost.

    CQT kernels are right-aligned and shrink with frequency, so high bins
    only ever multiply the last ``S`` samples of each frame — the rest of
    the dense kernel matrix is structural zeros. Bins
    are contiguous in decreasing length; a band = contiguous bin range
    sharing support ``S`` (the smallest power of two ≥ every length in the
    band, ≥128, and extractable without a gather — :func:`_valid_support`).

    Cost model (the JAX package's, so that both pick the same bands): a
    (M, S) @ (S, 2·n_b) matmul costs ``S · ceil(2·n_b / 128)`` 128-wide
    tiles — small bands waste columns, one big band wastes rows —
    so an exact O(n²·B) DP picks the partition, with a per-band constant
    (128·128) charging dispatch overhead. Returns ``[(start, stop, S)]``
    over bin indices; a single ``(0, n, n_fft)`` band means "use the dense
    path".
    """
    lengths = np.asarray(lengths)
    n = int(lengths.shape[0])
    if n == 0:
        return [(0, 0, n_fft)]

    def support(max_len: int) -> int:
        s = 128
        while s < max_len:
            s *= 2
        while s < n_fft and not _valid_support(s, n_fft, hop):
            s *= 2
        return min(s, n_fft)

    per_band_const = 128 * 128

    def band_cost(i: int, j: int) -> int:
        s = support(int(lengths[i:j].max()))
        return s * -(-2 * (j - i) // 128) * 128 + per_band_const

    # DP over contiguous partitions with at most max_bands bands.
    INF = float("inf")
    best = [[INF] * (n + 1) for _ in range(max_bands + 1)]
    choice = [[None] * (n + 1) for _ in range(max_bands + 1)]
    best[0][0] = 0.0
    for b in range(1, max_bands + 1):
        for j in range(1, n + 1):
            best[b][j] = best[b - 1][j]
            choice[b][j] = choice[b - 1][j]
            for i in range(j):
                if best[b - 1][i] == INF:
                    continue
                c = best[b - 1][i] + band_cost(i, j)
                if c < best[b][j]:
                    best[b][j] = c
                    choice[b][j] = (b - 1, i)
    bands = []
    b, j = max_bands, n
    while j > 0:
        prev = choice[b][j]
        if prev is None:  # pragma: no cover - defensive
            return [(0, n, n_fft)]
        pb, i = prev
        bands.append((i, j, support(int(lengths[i:j].max()))))
        b, j = pb, i
    bands.reverse()
    return bands


# ---------------------------------------------------------------------------
# Multi-rate (octave-stacked) CQT
# ---------------------------------------------------------------------------
#
# The reference clamps kernels longer than the frame (cqt.rs:376-384),
# silently reducing low-bin Q — at the musical preset (f_min=32.7 Hz,
# n_fft=4096, 44.1 kHz) bin 0 wants a 22678-sample kernel. Instead of
# inheriting the clamp, CqtParams(multirate=True) computes each octave
# against a 2^d-decimated copy of the signal: at rate sr/2^d the same
# time-extent kernel is 2^d× shorter in samples, so every bin keeps its
# full Q with frames never exceeding frame_length. Zero-phase half-band
# decimation (ops/decimate.py) keeps the decimated grid time-aligned, so
# level-d frame ends land on the exact instants of the full-rate frames.
#
# Value contract: coefficients match the *untruncated* direct CQT (the
# same params computed with a frame long enough for every kernel), not the
# truncated one. With normalize=True a kernel sampled at rate sr/2^d has
# 2^d× fewer samples, so the unit-energy normalization shrinks the
# correlation by 2^{-d/2}; the rows are pre-scaled by 2^{d/2} to restore
# the full-rate value (by 2^d for normalize=False — the Riemann-sum
# density factor). Verified against the long-kernel direct CQT in
# tests/test_cqt_erb.py.

def max_decimation(frame_length: int, hop: int, centre: bool) -> int:
    """Largest d such that every level-d frame end lies on the 2^d grid.

    Full-rate frame ends sit at i·hop + frame_length//2 (centre) or
    i·hop + frame_length (tail framing) — exact alignment needs
    2^d | hop and 2^d | the constant offset.
    """
    offset = frame_length // 2 if centre else frame_length
    d = 0
    while (
        d < 16
        and hop % (2 << d) == 0
        and offset % (2 << d) == 0
    ):
        d += 1
    return d


@lru_cache(maxsize=16)
def multirate_cqt_groups(params: CqtParams, sample_rate: float,
                         frame_length: int, hop: int, centre: bool,
                         depth: str = "min"):
    """Octave-stacked kernel groups for CqtParams(multirate=True).

    Returns ``(groups, freqs)`` where each group is
    ``(d, K_ri, e0, flen, jp)``: bins computed at decimation 2^d against
    ``flen``-sample frames of the decimated signal whose ends align
    with the full-rate frame ends. ``K_ri`` is the (flen,
    2·n_group_bins) f64 [re | −im] correlation matrix — *pre-scaled* so the
    result matches the untruncated full-rate CQT — with its columns in
    global bin order within the group (groups are contiguous in bin index,
    and when ``jp > 1`` the group is frame-packed: ``K_ri`` becomes the
    (flen + jp·hop_d, jp·2nb) block-banded super-kernel described below),
    low bins = deepest d). ``e0`` is the first frame's end index in the
    decimated signal. Bin b of group (lo, hi) is global bin lo+b; bins are
    ordered so concatenating groups in the returned order restores
    0..n_bins-1.

    ``depth="min"`` (quality default) decimates only as deep as full Q
    requires and keeps ``flen = frame_length`` everywhere — the d=0 group
    holds the exact single-rate kernels. ``depth="max"`` (speed) decimates
    every bin as deep as its band allows inside the half-band passband
    (``ops/decimate.py::HALFBAND_PASSBAND_FRAC``) and shrinks each group's
    frame to the power of two covering its kernels: each extra level is
    ~4× less matmul work for that octave, turning the octave stack into
    the fast path for low-f_min banks (the classic recursive-downsampling
    CQT, vs the reference's always-full-rate correlation
    ``cqt.rs:481-514``).
    """
    if depth not in ("min", "max"):
        raise InvalidInputError(f"depth must be 'min' or 'max', got {depth!r}")
    d_max = max_decimation(frame_length, hop, centre)

    # Per generated bin (below Nyquist, like the single-rate builder):
    # minimal d with kernel fitting the frame, capped at d_max; depth="max"
    # then deepens while the bin's band (centre + ~2.5 mainlobe widths,
    # width = fc/Q for a Q-long windowed tone) stays inside the decimated
    # half-band passband.
    fcs, ds = [], []
    still_truncated = []
    for bin_idx in range(params.num_bins):
        fc = params.bin_frequency(bin_idx)
        if fc >= sample_rate / 2.0:
            break
        full_len = int(np.round(params.q_factor * sample_rate / fc))
        d = 0
        while full_len > frame_length * (1 << d) and d < d_max:
            d += 1
        if depth == "max":
            band_top = fc * (1.0 + 2.5 / params.q_factor)
            while (
                d < d_max
                and band_top
                <= HALFBAND_PASSBAND_FRAC * sample_rate / (1 << (d + 2))
            ):
                d += 1
            # Prefer even depths: the consumer then decimates in stride-4
            # composite stages (0→2→4→…), never materializing the odd
            # levels — the cascade's HBM traffic, not the group matmuls,
            # dominates the octave stack. One level shallower costs this
            # group ~4× more (still microscopic) MACs; skipping an entire
            # signal-length intermediate saves real bandwidth.
            if d % 2 == 1 and d - 1 >= 0 and full_len <= frame_length * (1 << (d - 1)):
                d -= 1
        if full_len > frame_length * (1 << d):
            still_truncated.append((bin_idx, fc, full_len, d))
        fcs.append(fc)
        ds.append(d)

    if still_truncated:
        import warnings

        lo_bin, lo_fc, lo_len, d = still_truncated[0]
        warnings.warn(
            f"{len(still_truncated)} low CQT bin(s) remain truncated even at "
            f"the deepest aligned decimation 2^{d} (kernel {lo_len} > "
            f"{frame_length * (1 << d)} effective samples at bin {lo_bin}, "
            f"{lo_fc:.1f} Hz); increase n_fft or hop divisibility for full "
            "resolution",
            stacklevel=3,
        )

    # ds is non-increasing requirement? fc increases with bin ⇒ kernel
    # shortens ⇒ d non-increasing (both the fit and the band bound fall
    # with fc). Group contiguous runs of equal d.
    groups = []
    i = 0
    while i < len(fcs):
        j = i
        while j < len(fcs) and ds[j] == ds[i]:
            j += 1
        d = ds[i]
        D = 1 << d
        sr_d = sample_rate / D
        if depth == "max":
            # Shrink the group frame to the power of two covering its
            # longest kernel (≥ 128 samples): the matmul then reads only the
            # samples the kernels can see instead of frame_length-wide
            # frames of mostly structural zeros.
            longest = max(
                max(1, min(int(np.round(params.q_factor * sr_d / fcs[b])),
                           frame_length))
                for b in range(i, j)
            )
            flen = 128
            while flen < longest:
                flen *= 2
            flen = min(flen, frame_length)
        else:
            flen = frame_length
        rows_re, rows_im = [], []
        for b in range(i, j):
            row_re, row_mim, _ = _kernel_row(params, fcs[b], sr_d, flen)
            rows_re.append(row_re)
            rows_im.append(row_mim)
        scale = float(np.sqrt(D)) if params.normalize else float(D)
        k_ri = np.concatenate(
            [np.asarray(rows_re).T, np.asarray(rows_im).T], axis=1
        ) * scale
        e0 = (frame_length // 2 if centre else frame_length) // D
        # Deep groups have hop_d ≪ flen (>87%-overlapped frames): the
        # hopped-slice decomposition would take k = flen/hop_d partial
        # products, and a frame matrix is flen/hop_d times the signal. Pack
        # J consecutive frames into one block-banded
        # super-frame kernel (flen + J·hop_d rows, J·2nb cols; column block
        # m holds the kernels shifted to rows [m·hop_d, m·hop_d+flen)) so
        # the group becomes ONE framed matmul at super-hop J·hop_d, whose
        # k = flen/(J·hop_d) + 1 hopped slices stay on the fast path.
        # J = q/4 (q = flen/hop_d, both powers of two) ⇒ k = 5 parts,
        # 1.25× the ideal MACs, kernel ≤ 1.25·flen·(q/4)·2nb floats.
        # jp = J (1 = unpacked).
        hop_d = hop >> d
        jp = 1
        if hop_d > 0 and flen % hop_d == 0:
            q = flen // hop_d
            if q > 8 and q % 4 == 0:
                jp = q // 4
                nb2 = k_ri.shape[1]
                band = np.zeros((flen + jp * hop_d, jp * nb2))
                for m in range(jp):
                    band[m * hop_d : m * hop_d + flen,
                         m * nb2 : (m + 1) * nb2] = k_ri
                k_ri = band
        k_ri.setflags(write=False)
        groups.append((d, k_ri, e0, flen, jp))
        i = j

    freqs = np.asarray(fcs, dtype=np.float64)
    freqs.setflags(write=False)
    return tuple(groups), freqs
