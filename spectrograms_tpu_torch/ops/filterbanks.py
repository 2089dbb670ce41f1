"""Filterbank constant builders (mel, log-Hz, ERB, chroma).

A copy of ``spectrograms_tpu.ops.filterbanks``: the port imports nothing of
the JAX package.

All constants are constructed in float64 NumPy on the host and cast to the
compute dtype at the device edge — the same build-in-f64/cast-at-apply policy
as the reference (``src/spectrogram.rs:106-115``). Where the
reference stores these as sparse row lists for a per-frame SpMV
(``SparseMatrix``, ``src/spectrogram.rs:43-117``), we keep
them **dense**: the plain path applies them as one matmul over the whole frame
axis, and the fused kernel loops over each row's nonzero band of bins.

Formula parity:
- Slaney hz↔mel and frequency-space triangles + None/Slaney/L1/L2 norms:
  ``src/spectrogram.rs:2268-2432``
- log-Hz 1–2-tap interpolation matrix: ``:2438-2508``
- mel band centres: ``:2510-2530``
- ERB |H(f)|² gammatone responses, linear-in-ERB & Apple TR#35 spacings:
  ``src/erb.rs:195-330``
- chroma Gaussian pitch-class filterbank: ``src/chroma.rs:279-346``
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from ..errors import InvalidInputError
from ..params import (
    ChromaParams,
    ErbParams,
    ErbSpacing,
    MelNorm,
    MelParams,
    LogHzParams,
    N_CHROMA,
    r2c_output_size,
)

__all__ = [
    "hz_to_mel",
    "mel_to_hz",
    "mel_filterbank",
    "mel_band_centres_hz",
    "loghz_matrix",
    "hz_to_erb",
    "erb_to_hz",
    "erb_center_frequencies",
    "erb_filterbank",
    "chroma_filterbank",
]

# Slaney / librosa-default mel scale constants.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # 15.0
_LOGSTEP = math.log(6.4) / 27.0


def hz_to_mel(hz):
    """Hz → mel, Slaney formula (linear below 1 kHz, log above)."""
    hz = np.asarray(hz, dtype=np.float64)
    linear = hz / _F_SP
    logreg = _MIN_LOG_MEL + np.log(np.maximum(hz, 1e-300) / _MIN_LOG_HZ) / _LOGSTEP
    out = np.where(hz >= _MIN_LOG_HZ, logreg, linear)
    return out.item() if out.ndim == 0 else out


def mel_to_hz(mel):
    """Mel → Hz, inverse Slaney formula."""
    mel = np.asarray(mel, dtype=np.float64)
    linear = _F_SP * mel
    logreg = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL))
    out = np.where(mel >= _MIN_LOG_MEL, logreg, linear)
    return out.item() if out.ndim == 0 else out


@lru_cache(maxsize=128)
def _mel_filterbank_cached(sample_rate_hz, n_fft, n_mels, f_min, f_max, norm: MelNorm):
    if not (sample_rate_hz > 0.0 and math.isfinite(sample_rate_hz)):
        raise InvalidInputError("sample_rate_hz must be finite and > 0")
    if f_min < 0.0 or math.isinf(f_min):
        raise InvalidInputError("f_min must be >= 0")
    if f_max <= f_min:
        raise InvalidInputError("f_max must be > f_min")
    if f_max > sample_rate_hz * 0.5:
        raise InvalidInputError("f_max must be <= Nyquist")
    if n_mels > 10_000:
        raise InvalidInputError("n_mels is unreasonably large")

    out_len = r2c_output_size(n_fft)
    df = sample_rate_hz / n_fft

    # n_mels + 2 mel points → triangle edges, evenly spaced in mel.
    mel_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    bin_freqs = np.arange(out_len, dtype=np.float64) * df

    f_left = hz_pts[:-2, None]
    f_center = hz_pts[1:-1, None]
    f_right = hz_pts[2:, None]

    fdiff_left = f_center - f_left
    fdiff_right = f_right - f_center

    with np.errstate(divide="ignore", invalid="ignore"):
        lower = (bin_freqs[None, :] - f_left) / fdiff_left
        upper = (f_right - bin_freqs[None, :]) / fdiff_right
    fb = np.clip(np.minimum(lower, upper), 0.0, 1.0)
    # Degenerate triangles (zero bandwidth on either side) produce no filter.
    fb[np.ravel((fdiff_left == 0.0) | (fdiff_right == 0.0)), :] = 0.0
    fb = np.nan_to_num(fb, nan=0.0, posinf=0.0, neginf=0.0)

    if norm == MelNorm.SLANEY:
        # Area normalization in Hz bandwidth (librosa-compatible).
        enorm = 2.0 / (mel_to_hz(mel_pts[2:]) - mel_to_hz(mel_pts[:-2]))
        fb = fb * enorm[:, None]
    elif norm == MelNorm.L1:
        s = fb.sum(axis=1, keepdims=True)
        fb = np.where(s > 0.0, fb / np.where(s == 0.0, 1.0, s), fb)
    elif norm == MelNorm.L2:
        s = np.sqrt(np.square(fb).sum(axis=1, keepdims=True))
        fb = np.where(s > 0.0, fb / np.where(s == 0.0, 1.0, s), fb)

    fb.setflags(write=False)
    return fb


def mel_filterbank(sample_rate_hz: float, n_fft: int, mel: MelParams) -> np.ndarray:
    """Dense (n_mels, n_fft//2+1) mel filterbank, float64."""
    return _mel_filterbank_cached(
        float(sample_rate_hz), int(n_fft), mel.n_mels, mel.f_min, mel.f_max, mel.norm
    )


def mel_band_centres_hz(n_mels: int, sample_rate_hz: float, nyquist_hz: float) -> np.ndarray:
    """Mel band centre frequencies used for the mel frequency axis."""
    f_max = min(nyquist_hz, sample_rate_hz * 0.5)
    mel_min = hz_to_mel(0.0)
    mel_max = hz_to_mel(f_max)
    step = (mel_max - mel_min) / (n_mels + 1)
    mels = mel_min + step * np.arange(1, n_mels + 1, dtype=np.float64)
    return mel_to_hz(mels)


@lru_cache(maxsize=128)
def _loghz_matrix_cached(sample_rate_hz, n_fft, n_bins, f_min, f_max):
    if not (sample_rate_hz > 0.0 and math.isfinite(sample_rate_hz)):
        raise InvalidInputError("sample_rate_hz must be finite and > 0")
    if not (f_min > 0.0 and not math.isinf(f_min)):
        raise InvalidInputError("f_min must be finite and > 0")
    if f_max <= f_min:
        raise InvalidInputError("f_max must be > f_min")
    if f_max > sample_rate_hz * 0.5:
        raise InvalidInputError("f_max must be <= Nyquist")
    if n_bins > 10_000:
        raise InvalidInputError("n_bins is unreasonably large")

    out_len = r2c_output_size(n_fft)
    df = sample_rate_hz / n_fft

    if n_bins == 1:
        freqs = np.array([f_min], dtype=np.float64)
    else:
        freqs = np.exp(np.linspace(math.log(f_min), math.log(f_max), n_bins))

    mat = np.zeros((n_bins, out_len), dtype=np.float64)
    for i, f in enumerate(freqs):
        exact = f / df
        lower = int(math.floor(exact))
        upper = min(int(math.ceil(exact)), out_len - 1)
        if lower >= out_len:
            continue
        if lower == upper:
            mat[i, lower] = 1.0
        else:
            frac = exact - lower
            mat[i, lower] = 1.0 - frac
            if upper < out_len:
                mat[i, upper] = frac

    mat.setflags(write=False)
    freqs.setflags(write=False)
    return mat, freqs


def loghz_matrix(sample_rate_hz: float, n_fft: int, loghz: LogHzParams):
    """(matrix (n_bins, n_fft//2+1), frequencies) for log-Hz interpolation."""
    return _loghz_matrix_cached(
        float(sample_rate_hz), int(n_fft), loghz.n_bins, loghz.f_min, loghz.f_max
    )


# ---------------------------------------------------------------------------
# ERB / gammatone (frequency domain)
# ---------------------------------------------------------------------------

_EAR_Q = 9.26449
_MIN_BW = 24.7


def hz_to_erb(hz):
    """ERB(f) = 24.7·(4.37·f/1000 + 1) (Glasberg & Moore 1990)."""
    hz = np.asarray(hz, dtype=np.float64)
    out = 24.7 * (4.37 * hz / 1000.0 + 1.0)
    return out.item() if out.ndim == 0 else out


def erb_to_hz(erb):
    """Inverse of :func:`hz_to_erb`."""
    erb = np.asarray(erb, dtype=np.float64)
    out = (erb / 24.7 - 1.0) * 1000.0 / 4.37
    return out.item() if out.ndim == 0 else out


def erb_center_frequencies(params: ErbParams) -> np.ndarray:
    """Center frequencies (low→high) for either spacing strategy."""
    n = params.n_filters
    if params.spacing == ErbSpacing.LINEAR:
        erbs = np.linspace(hz_to_erb(params.f_min), hz_to_erb(params.f_max), n)
        return erb_to_hz(erbs)
    # Apple TR#35 / Patterson-Holdsworth geometric spacing, low→high.
    shift = _EAR_Q * _MIN_BW
    e = (math.log(params.f_min + shift) - math.log(params.f_max + shift)) / n
    i = np.arange(1, n + 1, dtype=np.float64)
    cfs = -shift + np.exp(i * e) * (params.f_max + shift)
    return cfs[::-1].copy()


@lru_cache(maxsize=64)
def _erb_filterbank_cached(sample_rate_hz, n_fft, n_filters, f_min, f_max, spacing):
    params = ErbParams(n_filters, f_min, f_max, spacing)
    if sample_rate_hz <= 0.0:
        raise InvalidInputError("sample_rate must be > 0")
    if n_filters > 10_000:
        raise InvalidInputError("n_filters is unreasonably large")
    cfs = erb_center_frequencies(params)

    n_bins = r2c_output_size(n_fft)
    freqs = np.arange(n_bins, dtype=np.float64) * (sample_rate_hz / n_fft)

    # 4th-order gammatone power response |1/(1 + j(f-fc)/(1.019·ERB(fc)))⁴|².
    bw = 1.019 * hz_to_erb(cfs)
    x = (freqs[None, :] - cfs[:, None]) / bw[:, None]
    denom_sq = 1.0 + x * x  # |1 + jx|²
    response = 1.0 / (denom_sq ** 4)

    response.setflags(write=False)
    cfs.setflags(write=False)
    return response, cfs


def erb_filterbank(sample_rate_hz: float, n_fft: int, params: ErbParams):
    """(|H|² matrix (n_filters, n_fft//2+1), center_freqs) for power spectra."""
    return _erb_filterbank_cached(
        float(sample_rate_hz), int(n_fft), params.n_filters, params.f_min,
        params.f_max, params.spacing,
    )


# ---------------------------------------------------------------------------
# Chroma
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def _chroma_filterbank_cached(sample_rate_hz, n_fft, tuning, f_min, f_max):
    if sample_rate_hz <= 0.0 or not math.isfinite(sample_rate_hz):
        raise InvalidInputError("sample_rate must be finite and > 0")
    n_bins = r2c_output_size(n_fft)
    freqs = np.arange(n_bins, dtype=np.float64) * (sample_rate_hz / n_fft)

    fb = np.zeros((N_CHROMA, n_bins), dtype=np.float64)
    in_range = (freqs >= f_min) & (freqs <= f_max) & (freqs > 0.0)

    with np.errstate(divide="ignore"):
        midi = 69.0 + 12.0 * np.log2(np.maximum(freqs, 1e-300) / tuning)
    pitch_class = np.mod(midi, 12.0)

    chroma_centers = np.arange(N_CHROMA, dtype=np.float64)[:, None]
    dist = np.abs(pitch_class[None, :] - chroma_centers)
    circular = np.minimum(dist, 12.0 - dist)
    weights = np.exp(-0.5 * np.square(circular))  # σ = 1 semitone
    fb = np.where(in_range[None, :], weights, 0.0)

    row_sums = fb.sum(axis=1, keepdims=True)
    fb = np.where(row_sums > 0.0, fb / np.where(row_sums == 0.0, 1.0, row_sums), fb)

    fb.setflags(write=False)
    return fb


def chroma_filterbank(sample_rate_hz: float, n_fft: int, params: ChromaParams) -> np.ndarray:
    """Dense (12, n_fft//2+1) Gaussian pitch-class filterbank, row-sum normed."""
    return _chroma_filterbank_cached(
        float(sample_rate_hz), int(n_fft), params.tuning, params.f_min, params.f_max
    )
