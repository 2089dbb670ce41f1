"""Binaural spatial-audio analysis: ITD / IPD / ILD / ILR spectrograms.

Counterpart of ``spectrograms_tpu.binaural`` (math of the reference's
src/binaural.rs, itself from QxLabIreland/Binaspect):

- ``magphase``: |X|^p and unit phase in one pass; zero bins → (0, 1+0j)
- ITD = wrapped interchannel phase difference / (2π·f) seconds over a bin
  range (default 50–620 Hz), 0 where both magnitudes vanish
- IPD = phase difference in radians, optionally wrapped to [−π, π]
- ILD = −20·log10(R/L) dB over 1700–4600 Hz, NaN where masked
- ILR = sign-symmetric normalized ratio in [−1, 1], NaN where masked
- per-type ``histogram()`` with the reference's bins, ranges and exponents
  (host numpy in float64, copied from the JAX package as it is)
- the comparators ``compute_itd_spectrogram_diff`` and
  ``compute_ilr_spectrogram_diff``

Both channels go through one batched STFT (``frame_signal`` and
``torch.fft.rfft``); the per-bin loops are elementwise tensor ops. Entry
points compute on CUDA unless given ``device="cpu"``; ``magphase`` computes
where its input lies (numpy input: the CPU). The ``_batch`` functions keep
an LRU of 32 device windows keyed by (kind, params, dtype, device).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .dtypes import dlpack_export, parse_dtype, real_dtype_name, resolve_device
from .errors import InvalidInputError
from .ops.framing import frame_signal
from .params import SpectrogramParams
from .windows import make_window

__all__ = [
    "magphase",
    "ITDSpectrogramParams",
    "IPDSpectrogramParams",
    "ILDSpectrogramParams",
    "ILRSpectrogramParams",
    "ItdSpectrogram",
    "IpdSpectrogram",
    "IldSpectrogram",
    "IlrSpectrogram",
    "compute_itd_spectrogram",
    "compute_ipd_spectrogram",
    "compute_ild_spectrogram",
    "compute_ilr_spectrogram",
    "compute_itd_spectrogram_diff",
    "compute_ilr_spectrogram_diff",
    "compute_itd_spectrogram_batch",
    "compute_ipd_spectrogram_batch",
    "compute_ild_spectrogram_batch",
    "compute_ilr_spectrogram_batch",
]


def magphase(complex_spect, power: int = 1):
    """(|X|^power, unit phase) from a complex spectrogram; zeros → (0, 1)."""
    if power < 1:
        raise InvalidInputError("power must be >= 1")
    c = torch.as_tensor(complex_spect)
    mag_sq = c.real ** 2 + c.imag ** 2 if c.is_complex() else c * c
    mag = torch.sqrt(mag_sq)
    if power == 1:
        mag_p = mag
    elif power == 2:
        mag_p = mag_sq
    else:
        mag_p = mag ** power
    zero = mag == 0
    safe = torch.where(zero, torch.ones_like(mag), mag)
    phase = torch.where(zero, torch.ones_like(c), c / safe)
    return mag_p, phase


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _validate_range(spec_params: SpectrogramParams, start_freq: float, stop_freq: float):
    sr = spec_params.sample_rate_hz
    if start_freq <= 0.0 or stop_freq <= 0.0:
        raise InvalidInputError("Start and end frequencies must be positive.")
    if start_freq >= stop_freq:
        raise InvalidInputError("Start frequency must be less than end frequency.")
    if stop_freq > sr / 2.0:
        raise InvalidInputError("End frequency must be less than Nyquist frequency.")


@dataclass(frozen=True)
class ITDSpectrogramParams:
    spectrogram_params: SpectrogramParams
    start_freq: float = 50.0
    end_freq: float = 620.0
    magphase_power: int = 1

    def __post_init__(self):
        _validate_range(self.spectrogram_params, self.start_freq, self.end_freq)
        if self.magphase_power < 1:
            raise InvalidInputError("magphase_power must be >= 1")


@dataclass(frozen=True)
class IPDSpectrogramParams:
    spectrogram_params: SpectrogramParams
    start_freq: float = 50.0
    end_freq: float = 620.0
    wrapped: bool = False

    def __post_init__(self):
        _validate_range(self.spectrogram_params, self.start_freq, self.end_freq)


@dataclass(frozen=True)
class ILDSpectrogramParams:
    spectrogram_params: SpectrogramParams
    start_freq: float = 1700.0
    end_freq: float = 4600.0

    def __post_init__(self):
        _validate_range(self.spectrogram_params, self.start_freq, self.end_freq)


@dataclass(frozen=True)
class ILRSpectrogramParams:
    spectrogram_params: SpectrogramParams
    start_freq: float = 1700.0
    end_freq: float = 4600.0

    def __post_init__(self):
        _validate_range(self.spectrogram_params, self.start_freq, self.end_freq)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


def _histogram_core(
    data: np.ndarray,
    num_bins: int,
    value_range: Tuple[float, float],
    exponent: int = 1,
    normalize: bool = False,
) -> np.ndarray:
    """(num_bins, n_frames) per-frame histogram with the reference's binning:
    one 2-D bincount over (bin, frame) flat indices."""
    vmin, vmax = value_range
    bin_width = (vmax - vmin) / num_bins
    n_frames = data.shape[1]
    vals = data.astype(np.float64)
    valid = np.isfinite(vals) & (vals >= vmin) & (vals <= vmax)
    idx = np.minimum(
        np.floor((vals - vmin) / bin_width).astype(np.int64), num_bins - 1
    )
    frame_col = np.broadcast_to(np.arange(n_frames, dtype=np.int64), vals.shape)
    # Invalid entries route to a spill slot (cheaper than boolean gathers).
    flat = np.where(valid, idx * n_frames + frame_col, num_bins * n_frames)
    hist = np.bincount(flat.ravel(), minlength=num_bins * n_frames + 1)
    hist = hist[: num_bins * n_frames].astype(np.float64).reshape(num_bins, n_frames)
    if exponent != 1:
        hist **= exponent
    if normalize:
        sums = hist.sum(axis=0, keepdims=True)
        hist = np.divide(hist, sums, out=hist, where=sums > 0)
    return hist


class _BinauralResult:
    """Shared result plumbing for the four binaural spectrogram types:
    ``data`` a tensor on the device it was computed on, the axes host
    numpy."""

    def __init__(self, data, params, frequencies, times):
        self.data = data
        self.params = params
        self.frequencies = np.asarray(frequencies)
        self.times = np.asarray(times)

    @property
    def n_bins(self) -> int:
        return self.data.shape[0]

    @property
    def n_frames(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self):
        return tuple(self.data.shape)

    def frequency_range(self) -> Tuple[float, float]:
        return (float(self.frequencies[0]), float(self.frequencies[-1]))

    def duration(self) -> float:
        return float(self.times[-1] - self.times[0])

    @property
    def dtype(self) -> str:
        """Dtype name (reference getter, python/binaural.rs:140)."""
        return real_dtype_name(self.data.dtype)

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.to_numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __dlpack__(self, stream=None, max_version=None, dl_device=None, copy=None):
        return dlpack_export(self.data, stream, max_version, dl_device, copy)

    def __dlpack_device__(self):
        return self.data.__dlpack_device__()


class ItdSpectrogram(_BinauralResult):
    """ITD values in seconds, (n_bins, n_frames)."""

    unit_label = "ITD (seconds)"

    def histogram(self, num_bins: Optional[int] = None,
                  delay_range: Optional[Tuple[float, float]] = None,
                  energy_weighted: bool = False, normalize: bool = False) -> np.ndarray:
        return _histogram_core(
            self.to_numpy(), num_bins or 400, delay_range or (-0.00088, 0.00088),
            1, normalize,
        )


class IpdSpectrogram(_BinauralResult):
    """IPD values in radians, (n_bins, n_frames)."""

    unit_label = "IPD (radians)"

    def histogram(self, num_bins: Optional[int] = None,
                  phase_range: Optional[Tuple[float, float]] = None,
                  energy_weighted: bool = False, normalize: bool = False) -> np.ndarray:
        return _histogram_core(
            self.to_numpy(), num_bins or 400, phase_range or (-math.pi, math.pi),
            1, normalize,
        )


class IldSpectrogram(_BinauralResult):
    """ILD values in dB, (n_bins, n_frames); masked cells are NaN."""

    unit_label = "ILD (dB)"

    def histogram(self, num_bins: Optional[int] = None,
                  db_range: Optional[Tuple[float, float]] = None,
                  exponent: Optional[int] = None,
                  energy_weighted: bool = False, normalize: bool = False) -> np.ndarray:
        return _histogram_core(
            self.to_numpy(), num_bins or 400, db_range or (-24.0, 24.0),
            3 if exponent is None else exponent, normalize,
        )


class IlrSpectrogram(_BinauralResult):
    """ILR values in [−1, 1], (n_bins, n_frames); masked cells are NaN."""

    unit_label = "ILR (ratio)"

    def histogram(self, num_bins: Optional[int] = None,
                  ratio_range: Optional[Tuple[float, float]] = None,
                  exponent: Optional[int] = None,
                  energy_weighted: bool = False, normalize: bool = False) -> np.ndarray:
        return _histogram_core(
            self.to_numpy(), num_bins or 400, ratio_range or (-1.0, 1.0),
            3 if exponent is None else exponent, normalize,
        )


# ---------------------------------------------------------------------------
# Computation
# ---------------------------------------------------------------------------


def _bin_range(params) -> Tuple[int, int, float]:
    sp = params.spectrogram_params
    bin_width = sp.sample_rate_hz / sp.stft.n_fft
    start_bin = int(round(params.start_freq / bin_width))
    stop_bin = int(round(params.end_freq / bin_width))
    return start_bin, stop_bin, bin_width


def _stereo_spec_math(stereo, w, n_fft: int, hop: int, centre: bool,
                      start_bin: int, stop_bin: int):
    """(..., 2, n) stereo → sliced complex (..., 2, bins, frames)."""
    frames = frame_signal(stereo, n_fft, hop, centre)
    spec = torch.fft.rfft(frames * w, dim=-1)       # (..., 2, frames, bins)
    return spec.transpose(-1, -2)[..., start_bin:stop_bin, :]


def _window(params, dt, dev) -> torch.Tensor:
    stft_p = params.spectrogram_params.stft
    return torch.tensor(make_window(stft_p.window, stft_p.n_fft, np.float64), dtype=dt,
                        device=dev)


def _stereo_stft_slices(audio, params, start_bin: int, stop_bin: int, dtype, device):
    """Both channels through one batched STFT → sliced (2, bins, frames)."""
    if len(audio) != 2:
        raise InvalidInputError("binaural analysis expects [left, right] audio")
    dt = parse_dtype(dtype)
    dev = resolve_device(device)
    left = torch.as_tensor(audio[0]).to(device=dev, dtype=dt).reshape(-1)
    right = torch.as_tensor(audio[1]).to(device=dev, dtype=dt).reshape(-1)
    if left.shape[0] == 0 or right.shape[0] == 0:
        raise InvalidInputError("signals must be non-empty")
    if left.shape != right.shape:
        raise InvalidInputError("left and right channels must have the same length")
    stft_p = params.spectrogram_params.stft
    return _stereo_spec_math(torch.stack([left, right]), _window(params, dt, dev),
                             stft_p.n_fft, stft_p.hop_size, stft_p.centre, start_bin, stop_bin)


def _axes(params, start_bin: int, stop_bin: int, bin_width: float, n_frames: int):
    freqs = np.arange(start_bin, stop_bin, dtype=np.float64) * bin_width
    sp = params.spectrogram_params
    times = np.arange(n_frames, dtype=np.float64) * sp.stft.hop_size / sp.sample_rate_hz
    return freqs, times


def _angle_diff(l_phase, r_phase):
    return torch.angle(l_phase) - torch.angle(r_phase)


def _wrap(diff):
    return torch.remainder(diff + math.pi, 2 * math.pi) - math.pi


def _itd_math(spec, start_bin: int, stop_bin: int, bin_width: float, power: int):
    l_mag, l_phase = magphase(spec[..., 0, :, :], power)
    r_mag, r_phase = magphase(spec[..., 1, :, :], power)
    wrapped = _wrap(_angle_diff(l_phase, r_phase))
    bins = torch.arange(start_bin, stop_bin, dtype=wrapped.dtype,
                        device=wrapped.device)[:, None]
    itd = wrapped / (2 * math.pi * bin_width * bins)
    return torch.where(l_mag + r_mag > 0, itd, torch.zeros_like(itd))


def _ipd_math(spec, wrapped: bool):
    _, l_phase = magphase(spec[..., 0, :, :], 1)
    _, r_phase = magphase(spec[..., 1, :, :], 1)
    diff = _angle_diff(l_phase, r_phase)
    return _wrap(diff) if wrapped else diff


def _ild_math(spec):
    l_mag, _ = magphase(spec[..., 0, :, :], 1)
    r_mag, _ = magphase(spec[..., 1, :, :], 1)
    valid = (l_mag > 0) & (r_mag > 0)
    one = torch.ones_like(l_mag)
    safe_l = torch.where(valid, l_mag, one)
    safe_r = torch.where(valid, r_mag, one)
    return torch.where(valid, -20.0 * torch.log10(safe_r / safe_l), torch.nan)


def _ilr_math(spec):
    l_mag, _ = magphase(spec[..., 0, :, :], 1)
    r_mag, _ = magphase(spec[..., 1, :, :], 1)
    valid = (l_mag > 0) & (r_mag > 0)
    one = torch.ones_like(l_mag)
    safe_l = torch.where(valid, l_mag, one)
    ratio = torch.where(valid, r_mag / safe_l, one)
    ilr = torch.where(ratio < 1.0, 1.0 - ratio, -(1.0 - 1.0 / ratio))
    return torch.where(valid, ilr, torch.nan)


def _compute(kind: str, audio, params, dtype, device):
    start_bin, stop_bin, bin_width = _bin_range(params)
    spec = _stereo_stft_slices(audio, params, start_bin, stop_bin, dtype, device)
    data = _kind_math(kind, spec, params, start_bin, stop_bin, bin_width)
    freqs, times = _axes(params, start_bin, stop_bin, bin_width, data.shape[-1])
    return _RESULTS[kind](data, params, freqs, times)


def _kind_math(kind: str, spec, params, start_bin: int, stop_bin: int, bin_width: float):
    if kind == "itd":
        return _itd_math(spec, start_bin, stop_bin, bin_width, params.magphase_power)
    if kind == "ipd":
        return _ipd_math(spec, params.wrapped)
    if kind == "ild":
        return _ild_math(spec)
    return _ilr_math(spec)


_RESULTS = {"itd": ItdSpectrogram, "ipd": IpdSpectrogram, "ild": IldSpectrogram,
            "ilr": IlrSpectrogram}


def compute_itd_spectrogram(audio, params: ITDSpectrogramParams, dtype=None,
                            device=None) -> ItdSpectrogram:
    """ITD spectrogram in seconds over the params' bin range.

    Examples
    --------
    A pure integer-lag stereo pair recovers its lag in seconds:

    >>> import numpy as np
    >>> import spectrograms_tpu_torch as tg
    >>> sr = 16000
    >>> left = np.random.default_rng(0).standard_normal(sr)
    >>> stereo = np.stack([left, np.roll(left, 8)])
    >>> p = tg.ITDSpectrogramParams(
    ...     tg.SpectrogramParams(tg.StftParams(1024, 256), sr))
    >>> itd = tg.compute_itd_spectrogram(stereo, p, device="cpu")
    >>> bool(abs(float(np.median(itd.to_numpy())) - 8 / sr) < 2e-4)
    True
    """
    return _compute("itd", audio, params, dtype, device)


def compute_ipd_spectrogram(audio, params: IPDSpectrogramParams, dtype=None,
                            device=None) -> IpdSpectrogram:
    """IPD spectrogram in radians (wrapped to [−π, π] if params.wrapped)."""
    return _compute("ipd", audio, params, dtype, device)


def compute_ild_spectrogram(audio, params: ILDSpectrogramParams, dtype=None,
                            device=None) -> IldSpectrogram:
    """ILD spectrogram: −20·log10(R/L) dB; masked cells NaN."""
    return _compute("ild", audio, params, dtype, device)


def compute_ilr_spectrogram(audio, params: ILRSpectrogramParams, dtype=None,
                            device=None) -> IlrSpectrogram:
    """ILR spectrogram in [−1, 1]; masked cells NaN."""
    return _compute("ilr", audio, params, dtype, device)


# ---------------------------------------------------------------------------
# Batch APIs — (B, 2, n) stereo batches as one batched computation
# ---------------------------------------------------------------------------

# LRU-bounded: a long-lived process sweeping many binaural configurations
# must not pin device windows without bound.
_BATCH_WINDOWS: "OrderedDict" = OrderedDict()
_BATCH_WINDOWS_MAX = 32


def _batch_window(kind: str, params, dt, dev) -> torch.Tensor:
    """The analysis window on ``dev``, cached per (kind, params, dtype, device)."""
    key = (kind, params, dt, dev)
    try:
        cached = _BATCH_WINDOWS.get(key)  # hashing happens here
    except TypeError:  # an unhashable custom window: build uncached
        return _window(params, dt, dev)
    if cached is not None:
        _BATCH_WINDOWS.move_to_end(key)
        return cached
    w = _window(params, dt, dev)
    while len(_BATCH_WINDOWS) >= _BATCH_WINDOWS_MAX:
        _BATCH_WINDOWS.popitem(last=False)
    _BATCH_WINDOWS[key] = w
    return w


def _batch(kind: str, audio_batch, params, dtype, device) -> torch.Tensor:
    dt = parse_dtype(dtype)
    dev = resolve_device(device)
    xb = torch.as_tensor(audio_batch)
    if xb.ndim != 3 or xb.shape[1] != 2:
        raise InvalidInputError(
            f"expected a (batch, 2, n_samples) stereo batch, got {tuple(xb.shape)}"
        )
    if xb.shape[2] == 0:
        raise InvalidInputError("signals must be non-empty")
    xb = xb.to(device=dev, dtype=dt)
    start_bin, stop_bin, bin_width = _bin_range(params)
    stft_p = params.spectrogram_params.stft
    spec = _stereo_spec_math(xb, _batch_window(kind, params, dt, dev), stft_p.n_fft,
                             stft_p.hop_size, stft_p.centre, start_bin, stop_bin)
    return _kind_math(kind, spec, params, start_bin, stop_bin, bin_width)


def compute_itd_spectrogram_batch(audio_batch, params: ITDSpectrogramParams, dtype=None,
                                  device=None) -> torch.Tensor:
    """ITD over a (B, 2, n) stereo batch → (B, bins, frames), on ``device``."""
    return _batch("itd", audio_batch, params, dtype, device)


def compute_ipd_spectrogram_batch(audio_batch, params: IPDSpectrogramParams, dtype=None,
                                  device=None) -> torch.Tensor:
    """IPD over a (B, 2, n) stereo batch → (B, bins, frames)."""
    return _batch("ipd", audio_batch, params, dtype, device)


def compute_ild_spectrogram_batch(audio_batch, params: ILDSpectrogramParams, dtype=None,
                                  device=None) -> torch.Tensor:
    """ILD over a (B, 2, n) stereo batch → (B, bins, frames)."""
    return _batch("ild", audio_batch, params, dtype, device)


def compute_ilr_spectrogram_batch(audio_batch, params: ILRSpectrogramParams, dtype=None,
                                  device=None) -> torch.Tensor:
    """ILR over a (B, 2, n) stereo batch → (B, bins, frames)."""
    return _batch("ilr", audio_batch, params, dtype, device)


# ---------------------------------------------------------------------------
# Diff comparators
# ---------------------------------------------------------------------------


def _median_finite(arr: np.ndarray) -> float:
    vals = np.sort(arr[np.isfinite(arr)])
    n = len(vals)
    if n == 0:
        return float("nan")
    if n % 2 == 0:
        return float((vals[n // 2 - 1] + vals[n // 2]) / 2.0)
    return float(vals[n // 2])


def compute_itd_spectrogram_diff(reference, test, params: ITDSpectrogramParams, dtype=None,
                                 device=None):
    """(per-frame mean ITD diff, mean diff in degrees, median ITD diff),
    host numpy."""
    ref = compute_itd_spectrogram(reference, params, dtype, device)
    tst = compute_itd_spectrogram(test, params, dtype, device)
    diff = tst.to_numpy() - ref.to_numpy()
    col_means = diff.mean(axis=0)
    mean_diff_degrees = float(np.mean(np.abs(col_means) * (1.0 / 0.00086) * 90.0))
    mean_diff_itd = _median_finite(col_means)
    return col_means, mean_diff_degrees, mean_diff_itd


def compute_ilr_spectrogram_diff(reference, test, params: ILRSpectrogramParams, dtype=None,
                                 device=None):
    """(per-frame NaN-mean ILR diff, mean |diff| over frames), host numpy."""
    ref = compute_ilr_spectrogram(reference, params, dtype, device)
    tst = compute_ilr_spectrogram(test, params, dtype, device)
    diff = tst.to_numpy() - ref.to_numpy()
    with np.errstate(invalid="ignore"):
        col_means = np.nanmean(np.where(np.isnan(diff), np.nan, diff), axis=0)
    finite = col_means[np.isfinite(col_means)]
    mean_diff = float(np.mean(np.abs(finite))) if len(finite) else float("nan")
    return col_means, mean_diff
