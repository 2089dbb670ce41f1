"""spectrograms_tpu_torch — the PyTorch/CUDA port of spectrograms_tpu.

A second package beside the JAX one, which stays as the reference. It
ports the flagship path: STFT → mel / log-Hz / ERB / linear → power /
magnitude / dB (``SpectrogramPlan``), → DCT-II MFCC (``MfccPlan``) and →
chroma (``ChromaPlan``), with the JAX package's one Pallas kernel rewritten
as two CUDA kernels for Hopper (``ops/fused_factored.py``): the f32
``csrc/fused_features.cu`` for ``precision=HIGH``, and the bf16 tensor-core
``csrc/fused_tier_features.cu`` for ``precision=DEFAULT`` and ``pallas:x2``. Names match
``spectrograms_tpu``. Entry points compute on CUDA unless given
``device="cpu"``; the package imports neither JAX nor ``spectrograms_tpu``.

Serving: ``FeaturePipeline`` reads WAV files (or decoded arrays) through
the native loader (``runtime/``, a ctypes binding to ``native/sgtpu.cpp``),
ships them as float32, int16 or μ-law and returns per-batch features with
frame masks; ``FeatureSet`` runs several plans over one batch, sharing the
multirate plans' decimation (``ops/decimate.py``).
"""

from __future__ import annotations

from .errors import (
    SpectrogramError,
    InvalidInputError,
    DimensionMismatchError,
    FftBackendError,
    InternalError,
    FFTBackendError,
)
from .dtypes import Precision, parse_dtype
from .windows import (
    WindowType,
    make_window,
    parse_window,
    hanning_window,
    hamming_window,
    blackman_window,
    rectangular_window,
    kaiser_window,
    gaussian_window,
)
from .params import (
    StftParams,
    StftParamsBuilder,
    SpectrogramParams,
    SpectrogramParamsBuilder,
    LogParams,
    MelNorm,
    MelParams,
    LogHzParams,
    ErbSpacing,
    ErbParams,
    GammatoneParams,
    CqtParams,
    ChromaNorm,
    ChromaParams,
    N_CHROMA,
    MfccParams,
    r2c_output_size,
)
from .pipeline import FreqScale, AmpScale, Spectrogram, SpectrogramPlan, StftPlan
from .mfcc import Mfcc, MfccPlan, mfcc, compute_mfcc, mfcc_from_log_mel, delta
from .chroma import (
    Chromagram,
    ChromaPlan,
    chromagram,
    chromagram_from_spectrogram,
    compute_chromagram,
)
from .ops.filterbanks import chroma_filterbank
from .convert import plan_constants_from_numpy
from .featureset import FeatureSet
from .serving import FeatureBatch, FeatureSetBatch, FeaturePipeline

__all__ = [
    "SpectrogramError",
    "InvalidInputError",
    "DimensionMismatchError",
    "FftBackendError",
    "InternalError",
    "FFTBackendError",
    "Precision",
    "parse_dtype",
    "WindowType",
    "make_window",
    "parse_window",
    "hanning_window",
    "hamming_window",
    "blackman_window",
    "rectangular_window",
    "kaiser_window",
    "gaussian_window",
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
    "FreqScale",
    "AmpScale",
    "Spectrogram",
    "SpectrogramPlan",
    "StftPlan",
    "Mfcc",
    "MfccPlan",
    "mfcc",
    "compute_mfcc",
    "mfcc_from_log_mel",
    "delta",
    "Chromagram",
    "ChromaPlan",
    "chromagram",
    "chromagram_from_spectrogram",
    "compute_chromagram",
    "chroma_filterbank",
    "plan_constants_from_numpy",
    "FeatureSet",
    "FeaturePipeline",
    "FeatureBatch",
    "FeatureSetBatch",
]
