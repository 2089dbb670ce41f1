"""Power-of-two decimation: the band-limited multirate front end.

Counterpart of ``spectrograms_tpu.ops.decimate``. A zero-phase half-band
Kaiser FIR (centre tap 0.5, even taps zero) feeds ``x[::2]``; zero phase
keeps the decimated samples on the original grid (y[m] ≈ x(2m·T)), which is
what lets a decimated plan's frames land on the full-rate frames' instants.
The multirate mel / log-Hz / chroma plans decimate with one composite stage
lowered as a banded framed matmul (``decimate_pow2_framed``); a
``FeatureSet`` shares the levels of one signal between its members through
``DecimationCascade``.

The products run in true f32 on the card (``check_true_f32``) and in the
input's dtype on the CPU; ``precision`` only keys which members may share
a cascade, as ``jax.lax.Precision`` does in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import Precision, check_true_f32
from ..spans import span
from .framing import framed_matmul

__all__ = [
    "HALFBAND_PASSBAND_FRAC",
    "band_limited_decimation_depth",
    "halfband_taps",
    "composite_taps",
    "decimate2",
    "decimate_pow2",
    "decimate2_strided",
    "decimate_pow2_strided",
    "decimate_pow2_framed",
    "DecimationCascade",
]

# The half-band decimator is flat to ~2e-5 up to this fraction of the
# decimated Nyquist (63-tap β=9 Kaiser); band-limited multirate paths engage
# only while the bank's f_max stays below it.
HALFBAND_PASSBAND_FRAC = 0.80


def band_limited_decimation_depth(sample_rate_hz: float, n_fft: int, hop_size: int,
                                  f_max: float) -> int:
    """Largest safe 2^d decimation (d ≤ 3) for a bank that is zero above ``f_max``.

    d is bounded by f_max fitting inside the decimated passband, by n_fft
    and hop staying divisible (so the decimated bin and frame grids are the
    full-rate ones) and by the decimated n_fft staying ≥ 32.
    """
    d = 0
    while d < 3:
        c = d + 1
        if (
            n_fft % (2**c) == 0
            and hop_size % (2**c) == 0
            and n_fft // (2**c) >= 32
            and f_max <= HALFBAND_PASSBAND_FRAC * sample_rate_hz / (2 ** (c + 1))
        ):
            d = c
        else:
            break
    return d


@lru_cache(maxsize=4)
def halfband_taps(n_taps: int = 63, beta: float = 9.0) -> np.ndarray:
    """Zero-phase half-band lowpass: odd length, h[centre]=0.5, even taps 0."""
    if n_taps % 2 == 0 or n_taps < 7:
        raise ValueError("n_taps must be odd and >= 7")
    m = (n_taps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    h = 0.5 * np.sinc(n / 2.0) * np.kaiser(n_taps, beta)
    h[(n % 2 == 0) & (n != 0)] = 0.0  # exact half-band structure
    h /= h.sum()  # unit DC gain
    h.setflags(write=False)
    return h


@lru_cache(maxsize=8)
def composite_taps(d: int, n_taps: int = 63, beta: float = 9.0) -> np.ndarray:
    """One full-rate FIR equal to ``d`` cascaded half-band stages.

    h_d = h ⊛ up₂(h) ⊛ up₄(h) ⊛ …, symmetric, of odd length
    (n_taps−1)·(2^d − 1) + 1. Filtering with h_d and keeping every 2^d-th
    sample equals the cascade away from the signal's ends.
    """
    h = halfband_taps(n_taps, beta)
    comp = np.array([1.0])
    for s in range(d):
        up = np.zeros((len(h) - 1) * (2**s) + 1)
        up[:: 2**s] = h
        comp = np.convolve(comp, up)
    comp.setflags(write=False)
    return comp


def _taps(x: torch.Tensor, taps: Optional[np.ndarray]) -> torch.Tensor:
    h = halfband_taps() if taps is None else taps
    return torch.tensor(np.asarray(h), dtype=x.dtype, device=x.device)


def _check_f32(x: torch.Tensor) -> None:
    if x.is_cuda and x.dtype == torch.float32:
        check_true_f32()


def decimate2(x: torch.Tensor, taps: Optional[np.ndarray] = None) -> torch.Tensor:
    """Anti-aliased 2× decimation of a 1-D signal (zero phase, same grid):
    ``convolve(x, h, mode="same")[::2]``."""
    _check_f32(x)
    h = _taps(x, taps)
    m = (h.shape[0] - 1) // 2
    # the taps are symmetric, so correlation is convolution
    y = F.conv1d(x.reshape(1, 1, -1), h.reshape(1, 1, -1), padding=m)
    return y.reshape(-1)[::2]


def decimate_pow2(x: torch.Tensor, d: int, taps: Optional[np.ndarray] = None) -> torch.Tensor:
    """d successive half-band 2× decimations (rate ÷ 2^d)."""
    for _ in range(d):
        x = decimate2(x, taps)
    return x


def decimate2_strided(x: torch.Tensor, taps: Optional[np.ndarray] = None) -> torch.Tensor:
    """:func:`decimate2` computing only the kept samples (one stride-2
    convolution); takes (..., n) inputs."""
    _check_f32(x)
    h = _taps(x, taps)
    m = (h.shape[0] - 1) // 2
    lead = x.shape[:-1]
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), h.reshape(1, 1, -1), stride=2, padding=m)
    return y[:, 0, :].reshape(*lead, y.shape[-1])


def decimate_pow2_strided(x: torch.Tensor, d: int,
                          taps: Optional[np.ndarray] = None) -> torch.Tensor:
    """d successive strided half-band 2× decimations (rate ÷ 2^d)."""
    for _ in range(d):
        x = decimate2_strided(x, taps)
    return x


@lru_cache(maxsize=8)
def _framed_decim_plan(d: int, hop: int):
    """(band matrix M (F, J) f64, F, J, left_pad) for 2^d framed decimation.

    Output block b holds y[J·b + j] = Σ_k h_d[k]·x[2^d·(J·b+j) + k − m]
    (zero-extended x): frame b of the m-left-padded signal (length F, hop
    H) dotted with M[t, j] = h_d[t − 2^d·j].
    """
    D = 2**d
    h = composite_taps(d)
    T = len(h)
    m = (T - 1) // 2
    H = hop
    J = H // D
    F_len = H * ((H + T - D + H - 1) // H)  # a whole number of hops
    M = np.zeros((F_len, J), dtype=np.float64)
    for j in range(J):
        M[D * j:D * j + T, j] = h
    M.setflags(write=False)
    return M, F_len, J, m


@lru_cache(maxsize=16)
def _band_matrix(d: int, hop: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(_framed_decim_plan(d, hop)[0], dtype=dtype, device=device)


def decimate_pow2_framed(x: torch.Tensor, d: int, precision=None,
                         hop: Optional[int] = None) -> torch.Tensor:
    """2^d decimation with the composite FIR as one banded framed matmul.

    Equal to :func:`decimate_pow2_strided` away from the signal's ends
    (within a composite-filter length of them the cascade truncates its
    intermediate and the composite does not). ``hop`` is the block hop, a
    positive multiple of 2^d; the default 64·2^d gives 64 outputs a block.
    ``precision`` is accepted for the JAX signature; the product is f32.
    """
    with span("tg.op.decimate.decimate_pow2_framed"):
        if d == 0:
            return x
        D = 2**d
        H = hop if hop is not None else 64 * D
        if H <= 0 or H % D != 0:
            raise ValueError(
                f"hop must be a positive multiple of 2^d = {D}, got {H}: each "
                "frame must advance a whole number of output samples"
            )
        _check_f32(x)
        n = x.shape[-1]
        n_out = -(-n // D)  # ceil, the strided cascade's length
        _, F_len, J, m = _framed_decim_plan(d, H)
        nb = -(-n_out // J)
        # Left pad m (band alignment); right pad so that frame nb-1, which reads
        # z[H·(nb-1) : H·(nb-1)+F], is in bounds.
        right = max(0, H * (nb - 1) + F_len - (n + m))
        z = F.pad(x, (m, right))
        band = _band_matrix(d, H, x.dtype, str(x.device))
        blocks = framed_matmul(z, band, F_len, H, centre=False)
        y = blocks[..., :nb, :].reshape(*x.shape[:-1], nb * J)
        return y[..., :n_out]


class DecimationCascade:
    """Lazy, shareable 2^d decimation levels of one zero-padded signal.

    Several multirate members of a ``FeatureSet`` decimate the *same*
    signal; a cascade computes each level once and hands every member the
    slice it would have computed itself. Levels are built over
    ``z = pad(x, (pad, pad))`` with :func:`decimate_pow2_framed`, which
    already treats samples out of range as zeros, so a slice of a
    deeper-padded level equals the decimation of a shallower-padded signal
    **bit for bit** for any single stage, as long as the pad difference is
    a whole number of the decimator's blocks. Chained stages (level ≥ 3)
    see the padded intermediate's real filter tails where a standalone
    cascade truncates them, and differ from it only near the signal's ends.

    ``composite=True`` (default) builds even levels by composite stride-4
    stages from the even level below, odd levels by one half-band from
    level d−1; ``composite=False`` builds every level by single half-bands.
    ``precision`` (a :class:`~spectrograms_tpu_torch.Precision`) keys the
    flavour; the products are f32 on the card.
    """

    def __init__(self, x: torch.Tensor, pad: int = 0, precision=None, composite: bool = True):
        self.n = int(x.shape[-1])
        self.pad = int(pad)
        self.precision = Precision.HIGH if precision is None else precision
        self.composite = bool(composite)
        if self.pad:
            x = F.pad(x, (self.pad, self.pad))
        self._levels = {0: x}

    def level(self, d: int) -> torch.Tensor:
        """Level-d decimation of the padded signal (its whole padded extent).

        A pure function of (d, composite), not of which levels exist
        already, so shared results never depend on the members' order.
        """
        if d not in self._levels:
            if self.composite and d >= 2 and d % 2 == 0:
                self._levels[d] = decimate_pow2_framed(self.level(d - 2), 2, self.precision)
            else:
                self._levels[d] = decimate_pow2_framed(self.level(d - 1), 1, self.precision)
        return self._levels[d]

    def level_slice(self, d: int, keep_pad: int = 0, length: Optional[int] = None):
        """Level d with exactly ``keep_pad`` full-rate pad samples kept.

        What ``decimate_pow2_framed(pad(x, keep_pad), d)`` would give (see
        the class docstring), cut or zero-extended on the right to
        ``length`` samples (default ceil((n + 2·keep_pad)/2^d)).
        ``keep_pad`` must be a multiple of 2^d and ≤ the cascade's pad.
        """
        with span("tg.op.decimate.DecimationCascade.level_slice"):
            D = 1 << d
            if keep_pad > self.pad or keep_pad % D or (self.pad - keep_pad) % D:
                raise ValueError(
                    f"keep_pad={keep_pad} incompatible with cascade pad={self.pad} at "
                    f"level {d} (need keep_pad ≤ pad, both ≡ 0 mod 2^{d})"
                )
            y = self.level(d)[..., (self.pad - keep_pad) // D:]
            if length is None:
                length = -(-(self.n + 2 * keep_pad) // D)
            if y.shape[-1] < length:
                y = F.pad(y, (0, length - y.shape[-1]))
            return y[..., :length]
