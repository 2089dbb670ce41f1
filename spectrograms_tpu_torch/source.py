"""Pluggable per-frame feature sources (the ``SpectrogramSource`` protocol).

Counterpart of ``spectrograms_tpu.source`` (the reference's
src/source.rs:39-350): a source turns a mono signal into an
(n_bands × n_frames) tensor and reports its band axes. The protocol is a
:class:`typing.Protocol`; :class:`PlanSource` adapts any port
``SpectrogramPlan`` (its forward, the fused kernel where the plan resolves
to it), and :class:`GammatoneSource`, :class:`CqtSource`,
:class:`ChromaSource` and :class:`MfccSource` wrap the port's one-shots,
computing on ``device`` (CUDA unless ``device="cpu"``).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from .chroma import chromagram
from .cqt import cqt
from .erb import gammatone_center_frequencies, gammatone_iir_spectrogram
from .mfcc import mfcc
from .ops.filterbanks import mel_band_centres_hz
from .params import ChromaParams, CqtParams, ErbParams, MfccParams, StftParams

__all__ = [
    "SpectrogramSource",
    "PlanSource",
    "GammatoneSource",
    "CqtSource",
    "ChromaSource",
    "MfccSource",
]


@runtime_checkable
class SpectrogramSource(Protocol):
    """A source of frame-wise features: signal → (n_bands, n_frames)."""

    def compute_matrix(self, samples): ...

    @property
    def n_bands(self) -> int: ...

    def center_frequencies(self) -> np.ndarray: ...

    @property
    def sample_rate(self) -> float: ...

    @property
    def hop_seconds(self) -> float: ...


class PlanSource:
    """Adapt any :class:`SpectrogramPlan` to the source protocol."""

    def __init__(self, plan):
        self._plan = plan

    def compute_matrix(self, samples):
        return self._plan.compute_raw(samples)

    @property
    def n_bands(self) -> int:
        return self._plan.n_output_bins

    def center_frequencies(self) -> np.ndarray:
        return self._plan.frequencies

    @property
    def sample_rate(self) -> float:
        return self._plan.params.sample_rate_hz

    @property
    def hop_seconds(self) -> float:
        return self._plan.params.frame_period_seconds()


class GammatoneSource:
    """Source backed by the time-domain IIR gammatone bank."""

    def __init__(self, sample_rate: float, frame_size: int, hop_size: int,
                 params: ErbParams, dtype=None, device=None):
        self._sr = float(sample_rate)
        self._frame_size = int(frame_size)
        self._hop = int(hop_size)
        self._params = params
        self._dtype = dtype
        self._device = device

    def compute_matrix(self, samples):
        out, _ = gammatone_iir_spectrogram(
            samples, self._sr, self._frame_size, self._hop, self._params, self._dtype,
            device=self._device,
        )
        return out

    @property
    def n_bands(self) -> int:
        return self._params.n_filters

    def center_frequencies(self) -> np.ndarray:
        return gammatone_center_frequencies(self._params)

    @property
    def sample_rate(self) -> float:
        return self._sr

    @property
    def hop_seconds(self) -> float:
        return self._hop / self._sr


class CqtSource:
    """Source backed by the standalone CQT (magnitude of the coefficients)."""

    def __init__(self, sample_rate: float, params: CqtParams, hop_size: int, dtype=None,
                 device=None):
        self._sr = float(sample_rate)
        self._params = params
        self._hop = int(hop_size)
        self._dtype = dtype
        self._device = device

    def compute_matrix(self, samples):
        return cqt(samples, self._sr, self._params, self._hop, self._dtype,
                   device=self._device).to_magnitude()

    @property
    def n_bands(self) -> int:
        return self._params.num_bins

    def center_frequencies(self) -> np.ndarray:
        return self._params.frequencies()

    @property
    def sample_rate(self) -> float:
        return self._sr

    @property
    def hop_seconds(self) -> float:
        return self._hop / self._sr


class ChromaSource:
    """Source producing 12 pitch-class rows."""

    def __init__(self, stft_params: StftParams, sample_rate: float,
                 params: ChromaParams = ChromaParams.music_standard(), dtype=None,
                 device=None):
        self._stft = stft_params
        self._sr = float(sample_rate)
        self._params = params
        self._dtype = dtype
        self._device = device

    def compute_matrix(self, samples):
        return chromagram(samples, self._stft, self._sr, self._params, self._dtype,
                          device=self._device).data

    @property
    def n_bands(self) -> int:
        return 12

    def center_frequencies(self) -> np.ndarray:
        # Pitch-class "centres": the first-octave semitone frequencies.
        base = self._params.f_min
        return base * 2.0 ** (np.arange(12) / 12.0)

    @property
    def sample_rate(self) -> float:
        return self._sr

    @property
    def hop_seconds(self) -> float:
        return self._stft.hop_size / self._sr


class MfccSource:
    """Source producing MFCC rows (band axis = cepstral index)."""

    def __init__(self, stft_params: StftParams, sample_rate: float, n_mels: int,
                 params: MfccParams = MfccParams(), dtype=None, device=None):
        self._stft = stft_params
        self._sr = float(sample_rate)
        self._n_mels = int(n_mels)
        self._params = params
        self._dtype = dtype
        self._device = device

    def compute_matrix(self, samples):
        return mfcc(samples, self._stft, self._sr, self._n_mels, self._params,
                    self._dtype, device=self._device).data

    @property
    def n_bands(self) -> int:
        n = self._params.n_mfcc
        return n - 1 if (not self._params.include_c0 and n > 1) else n

    def center_frequencies(self) -> np.ndarray:
        # Cepstral coefficients have no Hz centres: the mel band centres of
        # the underlying filterbank (as the reference reports).
        return mel_band_centres_hz(self._n_mels, self._sr, self._sr / 2.0)[: self.n_bands]

    @property
    def sample_rate(self) -> float:
        return self._sr

    @property
    def hop_seconds(self) -> float:
        return self._stft.hop_size / self._sr
