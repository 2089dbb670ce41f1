"""Validated parameter types, builders, and presets.

Parity with the reference's params surface:

- ``StftParams`` / ``SpectrogramParams`` + builders + presets
  (``src/spectrogram.rs:3444-4480``)
- ``LogParams`` (``:4052``), ``MelNorm``/``MelParams`` (``:3708-3860``),
  ``LogHzParams`` (``:3935-4042``)
- ``ErbParams``/``ErbSpacing`` (``src/erb.rs:14-130``)
- ``CqtParams`` + presets (``src/cqt.rs:17-298``)
- ``ChromaParams``/``ChromaNorm`` (``src/chroma.rs:16-160``)
- ``MfccParams`` (``src/mfcc.rs:15-120``)

All are frozen dataclasses: immutable and hashable, like the reference's
plan-keying params. A copy of ``spectrograms_tpu.params``: the port imports
nothing of the JAX package.
Validation is eager (construction-time), raising
:class:`~spectrograms_tpu_torch.errors.InvalidInputError`.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace
from typing import Optional

from .errors import InvalidInputError
from .windows import WindowType, parse_window

__all__ = [
    "StftParams",
    "StftParamsBuilder",
    "SpectrogramParams",
    "SpectrogramParamsBuilder",
    "LogParams",
    "MelNorm",
    "MelParams",
    "LogHzParams",
    "ErbSpacing",
    "ErbParams",
    "GammatoneParams",
    "CqtParams",
    "ChromaNorm",
    "ChromaParams",
    "N_CHROMA",
    "MfccParams",
    "r2c_output_size",
]

N_CHROMA = 12

DEFAULT_FLOOR_DB = -80.0


def r2c_output_size(n_fft: int) -> int:
    """Number of non-redundant rFFT bins: n_fft//2 + 1.

    Parity with ``r2c_output_size`` (``src/fft_backend.rs:16``).
    """
    return n_fft // 2 + 1


def _as_window(window) -> WindowType:
    if isinstance(window, str):
        return parse_window(window)
    if not isinstance(window, WindowType):
        raise InvalidInputError(f"window must be a WindowType or spec string, got {type(window)}")
    return window


def _check_positive_int(name: str, value) -> int:
    if not isinstance(value, (int,)) or isinstance(value, bool):
        raise InvalidInputError(f"{name} must be a positive integer, got {value!r}")
    if value <= 0:
        raise InvalidInputError(f"{name} must be > 0, got {value}")
    return int(value)


# ---------------------------------------------------------------------------
# STFT / spectrogram params
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StftParams:
    """STFT framing parameters (n_fft, hop_size, window, centre)."""

    n_fft: int
    hop_size: int
    window: WindowType = WindowType.HANNING
    centre: bool = True

    def __post_init__(self):
        object.__setattr__(self, "n_fft", _check_positive_int("n_fft", self.n_fft))
        object.__setattr__(self, "hop_size", _check_positive_int("hop_size", self.hop_size))
        object.__setattr__(self, "window", _as_window(self.window))
        if self.hop_size > self.n_fft:
            raise InvalidInputError("hop_size must be <= n_fft")
        if self.window.kind == "custom" and self.window.size != self.n_fft:
            raise InvalidInputError(
                f"Custom window size ({self.window.size}) must match n_fft ({self.n_fft})"
            )

    @property
    def n_bins(self) -> int:
        return r2c_output_size(self.n_fft)

    @staticmethod
    def builder() -> "StftParamsBuilder":
        return StftParamsBuilder()


class StftParamsBuilder:
    """Fluent builder, parity with ``StftParamsBuilder``."""

    def __init__(self):
        self._n_fft = None
        self._hop_size = None
        self._window = WindowType.HANNING
        self._centre = True

    def n_fft(self, n_fft: int) -> "StftParamsBuilder":
        self._n_fft = n_fft
        return self

    def hop_size(self, hop_size: int) -> "StftParamsBuilder":
        self._hop_size = hop_size
        return self

    def window(self, window) -> "StftParamsBuilder":
        self._window = window
        return self

    def centre(self, centre: bool) -> "StftParamsBuilder":
        self._centre = centre
        return self

    def build(self) -> StftParams:
        if self._n_fft is None:
            raise InvalidInputError("n_fft must be set")
        if self._hop_size is None:
            raise InvalidInputError("hop_size must be set")
        return StftParams(self._n_fft, self._hop_size, self._window, self._centre)


@dataclass(frozen=True)
class SpectrogramParams:
    """STFT params + sample rate.

    Accepts the rate positionally, as ``sample_rate_hz=`` or (reference
    keyword parity, ``params.rs:616``) as ``sample_rate=``.
    """

    stft: StftParams
    sample_rate_hz: float = None

    def __init__(self, stft, sample_rate_hz=None, *, sample_rate=None):
        if sample_rate_hz is None:
            sample_rate_hz = sample_rate
        if sample_rate_hz is None:
            raise InvalidInputError("sample_rate_hz (or sample_rate) is required")
        object.__setattr__(self, "stft", stft)
        object.__setattr__(self, "sample_rate_hz", sample_rate_hz)
        self.__post_init__()

    @property
    def sample_rate(self) -> float:
        """Alias of ``sample_rate_hz`` (reference getter name)."""
        return self.sample_rate_hz

    def __post_init__(self):
        sr = float(self.sample_rate_hz)
        if not (sr > 0.0 and math.isfinite(sr)):
            raise InvalidInputError("sample_rate_hz must be finite and > 0")
        object.__setattr__(self, "sample_rate_hz", sr)
        if not isinstance(self.stft, StftParams):
            raise InvalidInputError("stft must be an StftParams instance")

    @staticmethod
    def speech_default(sample_rate_hz: float) -> "SpectrogramParams":
        """n_fft=512, hop=160, Hanning, centred (32 ms / 10 ms @16 kHz)."""
        return SpectrogramParams(StftParams(512, 160), sample_rate_hz)

    @staticmethod
    def music_default(sample_rate_hz: float) -> "SpectrogramParams":
        """n_fft=2048, hop=512, Hanning, centred (46 ms / 11.6 ms @44.1 kHz)."""
        return SpectrogramParams(StftParams(2048, 512), sample_rate_hz)

    @staticmethod
    def builder() -> "SpectrogramParamsBuilder":
        return SpectrogramParamsBuilder()

    def frame_period_seconds(self) -> float:
        return self.stft.hop_size / self.sample_rate_hz

    def nyquist_hz(self) -> float:
        return self.sample_rate_hz * 0.5


class SpectrogramParamsBuilder:
    """Fluent builder, parity with ``SpectrogramParamsBuilder``."""

    def __init__(self):
        self._sample_rate = None
        self._n_fft = None
        self._hop_size = None
        self._window = WindowType.HANNING
        self._centre = True

    def sample_rate(self, sample_rate_hz: float) -> "SpectrogramParamsBuilder":
        self._sample_rate = sample_rate_hz
        return self

    def n_fft(self, n_fft: int) -> "SpectrogramParamsBuilder":
        self._n_fft = n_fft
        return self

    def hop_size(self, hop_size: int) -> "SpectrogramParamsBuilder":
        self._hop_size = hop_size
        return self

    def window(self, window) -> "SpectrogramParamsBuilder":
        self._window = window
        return self

    def centre(self, centre: bool) -> "SpectrogramParamsBuilder":
        self._centre = centre
        return self

    def build(self) -> SpectrogramParams:
        if self._sample_rate is None:
            raise InvalidInputError("sample_rate must be set")
        if self._n_fft is None:
            raise InvalidInputError("n_fft must be set")
        if self._hop_size is None:
            raise InvalidInputError("hop_size must be set")
        stft = StftParams(self._n_fft, self._hop_size, self._window, self._centre)
        return SpectrogramParams(stft, self._sample_rate)


@dataclass(frozen=True)
class LogParams:
    """dB scaling parameters: the noise floor in dB (default -80)."""

    floor_db: float = DEFAULT_FLOOR_DB

    def __post_init__(self):
        fd = float(self.floor_db)
        if not math.isfinite(fd):
            raise InvalidInputError("floor_db must be finite")
        object.__setattr__(self, "floor_db", fd)


# ---------------------------------------------------------------------------
# Frequency-scale params
# ---------------------------------------------------------------------------


class MelNorm(enum.Enum):
    """Mel filterbank normalization (None / Slaney / L1 / L2).

    The lowercase names are aliases (``MelNorm.slaney is MelNorm.SLANEY``)
    matching the reference pyclass's classattrs
    (``src/python/params.rs:733-749``).
    """

    NONE = "none"
    SLANEY = "slaney"
    L1 = "l1"
    L2 = "l2"
    # enum aliasing: equal values bind extra NAMES to the same members
    none = "none"
    slaney = "slaney"
    l1 = "l1"
    l2 = "l2"

    @classmethod
    def parse(cls, v) -> "MelNorm":
        if isinstance(v, cls):
            return v
        if v is None:
            return cls.NONE
        if isinstance(v, str):
            key = v.strip().lower()
            for member in cls:
                if member.value == key:
                    return member
        raise InvalidInputError(f"unknown MelNorm {v!r}")


@dataclass(frozen=True)
class MelParams:
    """Mel filterbank parameters (n_mels, f_min, f_max, norm).

    ``multirate=True`` lets plans compute the (band-limited) mel features
    on an anti-aliased 2^d-decimated copy of the signal when f_max leaves
    headroom below the decimated Nyquist: the DFT bin grid is unchanged,
    so the filterbank columns are identical and values match the full-rate
    plan to ~1e-5 relative to the spectral peak, at ~4^d× less DFT work.
    (Bins ≳50 dB below the peak hold only window-leakage energy; there the
    decimated copy folds different leakage tails and per-bin dB values may
    differ at their own tiny magnitude.) Exact no-op when f_max is at/near
    Nyquist (e.g. the 16 kHz speech presets). Extension beyond the
    reference, which always computes the full-rate spectrum.
    """

    n_mels: int
    f_min: float
    f_max: float
    norm: MelNorm = MelNorm.NONE
    multirate: bool = False

    def __post_init__(self):
        object.__setattr__(self, "n_mels", _check_positive_int("n_mels", self.n_mels))
        object.__setattr__(self, "f_min", float(self.f_min))
        object.__setattr__(self, "f_max", float(self.f_max))
        object.__setattr__(self, "norm", MelNorm.parse(self.norm))
        object.__setattr__(self, "multirate", bool(self.multirate))
        if self.f_min < 0.0:
            raise InvalidInputError("f_min must be >= 0")
        if self.f_max <= self.f_min:
            raise InvalidInputError("f_max must be > f_min")

    @staticmethod
    def with_norm(n_mels: int, f_min: float, f_max: float, norm) -> "MelParams":
        return MelParams(n_mels, f_min, f_max, norm)

    def with_multirate(self, multirate: bool = True) -> "MelParams":
        return replace(self, multirate=bool(multirate))


@dataclass(frozen=True)
class LogHzParams:
    """Log-spaced linear-interpolation frequency axis parameters.

    ``multirate=True`` — see :class:`MelParams`: the 1–2-tap interpolation
    matrix is zero above f_max, so the same decimated-copy fast path
    applies.
    """

    n_bins: int
    f_min: float
    f_max: float
    multirate: bool = False

    def __post_init__(self):
        object.__setattr__(self, "n_bins", _check_positive_int("n_bins", self.n_bins))
        object.__setattr__(self, "f_min", float(self.f_min))
        object.__setattr__(self, "f_max", float(self.f_max))
        object.__setattr__(self, "multirate", bool(self.multirate))
        if not (self.f_min > 0.0 and math.isfinite(self.f_min)):
            raise InvalidInputError("f_min must be finite and > 0")
        if self.f_max <= self.f_min:
            raise InvalidInputError("f_max must be > f_min")

    def with_multirate(self, multirate: bool = True) -> "LogHzParams":
        return replace(self, multirate=bool(multirate))

    @staticmethod
    def standard(sample_rate: float) -> "LogHzParams":
        """128 log bins from 20 Hz to Nyquist."""
        return LogHzParams(128, 20.0, sample_rate / 2.0)

    @staticmethod
    def music_standard() -> "LogHzParams":
        """84 bins (7 octaves × 12) from 27.5 Hz (A0) to 4186 Hz (C8)."""
        return LogHzParams(84, 27.5, 4186.0)


class ErbSpacing(enum.Enum):
    """ERB center-frequency spacing strategy."""

    # evenly spaced ERB bandwidths 24.7·(4.37·f/1000 + 1) (Glasberg & Moore
    # 1990), which are affine in f: centres uniform in Hz
    LINEAR = "linear"
    # Patterson-Holdsworth (Slaney): centres uniform on the ERB-rate scale
    # ln(1 + f/(EarQ·minBW)), f_min included and f_max left out
    APPLE_TR35 = "apple_tr35"


@dataclass(frozen=True)
class ErbParams:
    """ERB / gammatone filterbank parameters.

    ``db_floor=None`` leaves linear output; a float converts to dB with that
    noise floor (parity with ``ErbParams.with_db_floor``,
    ``src/erb.rs:100-110``).
    """

    n_filters: int
    f_min: float
    f_max: float
    spacing: ErbSpacing = ErbSpacing.LINEAR
    db_floor: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "n_filters", _check_positive_int("n_filters", self.n_filters))
        object.__setattr__(self, "f_min", float(self.f_min))
        object.__setattr__(self, "f_max", float(self.f_max))
        if self.n_filters < 2:
            raise InvalidInputError(
                "n_filters must be >= 2 (single filter would cause division by zero)"
            )
        if self.f_min < 0.0 or math.isinf(self.f_min):
            raise InvalidInputError("f_min must be finite and >= 0")
        if self.f_max <= self.f_min:
            raise InvalidInputError("f_max must be > f_min")
        if self.db_floor is not None:
            fd = float(self.db_floor)
            if not math.isfinite(fd):
                raise InvalidInputError("db_floor must be finite")
            object.__setattr__(self, "db_floor", fd)

    def with_spacing(self, spacing: ErbSpacing) -> "ErbParams":
        return replace(self, spacing=spacing)

    def with_db_floor(self, floor_db: float) -> "ErbParams":
        return replace(self, db_floor=float(floor_db))


GammatoneParams = ErbParams


@dataclass(frozen=True)
class CqtParams:
    """Constant-Q transform parameters.

    ``q_factor`` defaults to ``1 / (2^(1/bins_per_octave) - 1)``.

    ``multirate=True`` computes low octaves against 2^d-decimated copies of
    the signal (octave-stacked CQT) instead of inheriting the reference's
    kernel clamp (``cqt.rs:376-384``): bins whose kernels exceed the frame
    keep their full Q. Values then match the *untruncated* direct CQT (same
    params with a frame long enough for every kernel) to anti-alias-filter
    accuracy, not the truncated one. Beyond-parity extension (off by
    default); streaming ``compute_frame`` keeps single-rate kernels.

    ``multirate_depth`` picks the octave-stacking policy:

    - ``"min"`` (default): decimate only as deep as full Q requires — the
      d=0 group keeps the exact single-rate kernels, so plans whose kernels
      all fit are bitwise unchanged.
    - ``"max"``: decimate every octave as deep as its band allows (inside
      the half-band passband) and shrink each group's frame to its kernels
      — per-octave work drops ~4× per extra level, making the multirate
      CQT a *speed* path, at the cost of half-band passband flatness
      (~2e-5/level) on bins that previously ran at the full rate.

    ``truncate`` is the correctness-of-defaults policy for kernels longer
    than the analysis frame (the reference silently clamps them,
    ``cqt.rs:376-384``, which costs up to ~64 % value error on low bins
    vs the untruncated ideal — ``benchmarks/cqt_multirate_ab.json``):

    - ``None`` (default, *auto*): plans and :func:`cqt` switch to the
      full-Q octave-stacked multirate path (``depth="max"``) whenever any
      kernel would lose more than 1 % of its effective Q to truncation
      (``TRUNCATION_Q_LOSS_THRESHOLD``) and the frame/hop alignment
      admits decimation — correct by default, ~1.4× the dense cost.
    - ``True``: keep the reference-parity dense truncated kernels (the
      speed tier) without the truncation warning — an explicit,
      documented accuracy trade.
    - ``False``: require full Q — always use the multirate path when
      truncation would occur, and keep the residual-truncation warning if
      even the deepest aligned decimation cannot restore it.

    An explicit ``multirate=True`` overrides ``truncate`` entirely.
    """

    bins_per_octave: int
    n_octaves: int
    f_min: float
    q_factor: Optional[float] = None
    window: WindowType = WindowType.HANNING
    sparsity_threshold: float = 0.01
    normalize: bool = True
    multirate: bool = False
    multirate_depth: str = "min"
    truncate: Optional[bool] = None

    def __post_init__(self):
        object.__setattr__(
            self, "bins_per_octave", _check_positive_int("bins_per_octave", self.bins_per_octave)
        )
        object.__setattr__(self, "n_octaves", _check_positive_int("n_octaves", self.n_octaves))
        object.__setattr__(self, "f_min", float(self.f_min))
        object.__setattr__(self, "window", _as_window(self.window))
        if not (self.f_min > 0.0 and math.isfinite(self.f_min)):
            raise InvalidInputError("f_min must be finite and > 0")
        if self.q_factor is None:
            q = 1.0 / (2.0 ** (1.0 / self.bins_per_octave) - 1.0)
            object.__setattr__(self, "q_factor", q)
        else:
            q = float(self.q_factor)
            if not (q > 0.0 and math.isfinite(q)):
                raise InvalidInputError("q_factor must be finite and > 0")
            object.__setattr__(self, "q_factor", q)
        object.__setattr__(
            self, "sparsity_threshold", max(0.0, float(self.sparsity_threshold))
        )
        object.__setattr__(self, "multirate", bool(self.multirate))
        if self.multirate_depth not in ("min", "max"):
            raise InvalidInputError(
                f"multirate_depth must be 'min' or 'max', got "
                f"{self.multirate_depth!r}"
            )
        if self.truncate is not None:
            object.__setattr__(self, "truncate", bool(self.truncate))

    # fluent modifiers (parity with with_* methods)
    def with_q_factor(self, q_factor: float) -> "CqtParams":
        return replace(self, q_factor=float(q_factor))

    def with_window(self, window) -> "CqtParams":
        return replace(self, window=_as_window(window))

    def with_sparsity(self, threshold: float) -> "CqtParams":
        return replace(self, sparsity_threshold=max(0.0, float(threshold)))

    def with_normalize(self, normalize: bool) -> "CqtParams":
        return replace(self, normalize=bool(normalize))

    def with_multirate(
        self, multirate: bool = True, depth: Optional[str] = None
    ) -> "CqtParams":
        return replace(
            self,
            multirate=bool(multirate),
            multirate_depth=self.multirate_depth if depth is None else depth,
        )

    def with_truncate(self, truncate: Optional[bool]) -> "CqtParams":
        """Set the long-kernel policy (see the class docstring)."""
        return replace(
            self, truncate=None if truncate is None else bool(truncate)
        )

    @property
    def num_bins(self) -> int:
        return self.bins_per_octave * self.n_octaves

    def bin_frequency(self, bin_idx: int) -> float:
        return self.f_min * 2.0 ** (bin_idx / self.bins_per_octave)

    def bin_bandwidth(self, bin_idx: int) -> float:
        return self.bin_frequency(bin_idx) / self.q_factor

    def frequencies(self):
        import numpy as np

        return np.array([self.bin_frequency(i) for i in range(self.num_bins)])

    # ---- presets (parity with src/cqt.rs:226-298) ----
    @staticmethod
    def percussive() -> "CqtParams":
        return CqtParams(12, 7, 32.7)

    @staticmethod
    def onset_detection() -> "CqtParams":
        return CqtParams(24, 6, 55.0, q_factor=0.5, sparsity_threshold=0.02)

    @staticmethod
    def chord_detection() -> "CqtParams":
        return CqtParams(36, 5, 82.4, q_factor=0.8, sparsity_threshold=0.02)

    @staticmethod
    def harmonic() -> "CqtParams":
        return CqtParams(24, 7, 55.0, q_factor=1.0, sparsity_threshold=0.005)

    @staticmethod
    def musical() -> "CqtParams":
        return CqtParams(12, 7, 32.7, q_factor=1.0, sparsity_threshold=0.01)


class ChromaNorm(enum.Enum):
    """Per-frame chroma normalization (None / L1 / L2 / Max)."""

    NONE = "none"
    L1 = "l1"
    L2 = "l2"
    MAX = "max"


@dataclass(frozen=True)
class ChromaParams:
    """Chromagram parameters (12 pitch classes, A4 tuning reference).

    ``multirate=True`` lets plans compute the (band-limited) chromagram on
    an anti-aliased 2^d-decimated copy of the signal when the bank is zero
    over the discarded band: the DFT bin grid is unchanged
    (sr/2^d ÷ n_fft/2^d), so the filterbank columns are identical and the
    result matches the full-rate chromagram to ~1e-5 relative (measured
    ≤5e-6 on band-limited and broadband test signals; tests assert ≤2e-4
    with margin) while doing ~4^d× less DFT work. Extension beyond the
    reference (which always computes the full-rate spectrum,
    chroma.rs:365-403).
    """

    tuning: float = 440.0
    f_min: float = 32.7  # C1
    f_max: float = 4186.0  # C8
    norm: ChromaNorm = ChromaNorm.L2
    n_octaves: Optional[int] = None  # derived ceil(log2(f_max/f_min)) if None
    multirate: bool = False

    def __post_init__(self):
        object.__setattr__(self, "tuning", float(self.tuning))
        object.__setattr__(self, "f_min", float(self.f_min))
        object.__setattr__(self, "f_max", float(self.f_max))
        object.__setattr__(self, "multirate", bool(self.multirate))
        if not (self.tuning > 0.0 and math.isfinite(self.tuning)):
            raise InvalidInputError("tuning must be finite and > 0")
        if not (self.f_min > 0.0 and math.isfinite(self.f_min)):
            raise InvalidInputError("f_min must be finite and > 0")
        if self.f_max <= self.f_min:
            raise InvalidInputError("f_max must be > f_min")
        if self.n_octaves is None:
            derived = max(1, math.ceil(math.log2(self.f_max / self.f_min)))
            object.__setattr__(self, "n_octaves", derived)

    @staticmethod
    def music_standard() -> "ChromaParams":
        # Hardcodes 7 octaves (C1..C8) like the reference const constructor.
        return ChromaParams(440.0, 32.7, 4186.0, ChromaNorm.L2, n_octaves=7)

    def with_norm(self, norm: ChromaNorm) -> "ChromaParams":
        return replace(self, norm=norm)

    def with_multirate(self, multirate: bool = True) -> "ChromaParams":
        return replace(self, multirate=bool(multirate))


@dataclass(frozen=True)
class MfccParams:
    """MFCC parameters (n_mfcc, include_c0, lifter)."""

    n_mfcc: int = 13
    include_c0: bool = True
    lifter: int = 22

    def __post_init__(self):
        object.__setattr__(self, "n_mfcc", _check_positive_int("n_mfcc", self.n_mfcc))
        lifter = self.lifter
        if not isinstance(lifter, int) or isinstance(lifter, bool) or lifter < 0:
            raise InvalidInputError(f"lifter must be a non-negative integer, got {lifter!r}")

    @staticmethod
    def speech_standard() -> "MfccParams":
        return MfccParams(13, True, 22)

    def with_c0(self, include_c0: bool) -> "MfccParams":
        return replace(self, include_c0=bool(include_c0))

    def with_lifter(self, lifter: int) -> "MfccParams":
        return replace(self, lifter=int(lifter))
