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

The spectrogram family: ``stft``/``istft`` and the one-shot FFTs
(``ops/stft.py``), ``StftPlan``, ``SpectrogramPlanner`` and the 15 typed
plans (``plans.py``), the ``compute_*`` one-shots and their plan cache
(``functions.py``, ``cache.py``), and Griffin-Lim reconstruction
(``reconstruct.py``).

The constant-Q transform (``cqt``, ``CqtResult`` and the ``Cqt*Plan``s,
dense, banded or octave-stacked multirate: ``ops/cqt.py``, ``cqt.py``), the
MDCT (``mdct.py``) and the ERB gammatone bank (``erb.py``); ``audio`` is the
audio namespace module.

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
from .dtypes import (
    Precision,
    complex_dtype,
    ensure_x64,
    get_default_dtype,
    parse_dtype,
    set_default_dtype,
)
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
from .pipeline import (
    FreqScale,
    AmpScale,
    Spectrogram,
    SpectrogramPlan,
    SpectrogramPlanner,
    StftPlan,
    StftResult,
)
from .plans import (
    LinearPowerPlan,
    LinearMagnitudePlan,
    LinearDbPlan,
    MelPowerPlan,
    MelMagnitudePlan,
    MelDbPlan,
    ErbPowerPlan,
    ErbMagnitudePlan,
    ErbDbPlan,
    LogHzPowerPlan,
    LogHzMagnitudePlan,
    LogHzDbPlan,
    CqtPowerPlan,
    CqtMagnitudePlan,
    CqtDbPlan,
)
from .ops.stft import fft, rfft, irfft, power_spectrum, magnitude_spectrum, stft, istft
from .ops.filterbanks import (
    hz_to_mel,
    mel_to_hz,
    hz_to_erb,
    erb_to_hz,
    mel_filterbank,
    chroma_filterbank,
)
from .functions import *  # noqa: F401,F403 — the compute_* one-shots
from .functions import __all__ as _functions_all
from .mfcc import Mfcc, MfccPlan, mfcc, compute_mfcc, mfcc_from_log_mel, delta
from .chroma import (
    Chromagram,
    ChromaPlan,
    chromagram,
    chromagram_from_spectrogram,
    compute_chromagram,
)
from .cqt import CqtResult, cqt
from .erb import ErbFilterbank, gammatone_center_frequencies, gammatone_iir_spectrogram
from .mdct import MdctParams, mdct, imdct, compute_mdct, compute_imdct
from .reconstruct import griffin_lim, mel_to_linear, invert_mel_db, mel_filterbank_pinv
from .convert import plan_constants_from_numpy
from .featureset import FeatureSet
from .serving import FeatureBatch, FeatureSetBatch, FeaturePipeline
from . import runtime
from .cache import fft_plan_cache_info, clear_fft_plan_cache, cache_stats

__version__ = "0.5.1"

__all__ = [
    "SpectrogramError",
    "InvalidInputError",
    "DimensionMismatchError",
    "FftBackendError",
    "InternalError",
    "FFTBackendError",
    "Precision",
    "parse_dtype",
    "set_default_dtype",
    "get_default_dtype",
    "complex_dtype",
    "ensure_x64",
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
    "SpectrogramPlanner",
    "StftPlan",
    "StftResult",
    "LinearPowerPlan",
    "LinearMagnitudePlan",
    "LinearDbPlan",
    "MelPowerPlan",
    "MelMagnitudePlan",
    "MelDbPlan",
    "ErbPowerPlan",
    "ErbMagnitudePlan",
    "ErbDbPlan",
    "LogHzPowerPlan",
    "LogHzMagnitudePlan",
    "LogHzDbPlan",
    "CqtPowerPlan",
    "CqtMagnitudePlan",
    "CqtDbPlan",
    "__version__",
    "fft",
    "rfft",
    "irfft",
    "power_spectrum",
    "magnitude_spectrum",
    "stft",
    "istft",
    "hz_to_mel",
    "mel_to_hz",
    "hz_to_erb",
    "erb_to_hz",
    "mel_filterbank",
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
    "CqtResult",
    "cqt",
    "ErbFilterbank",
    "gammatone_center_frequencies",
    "gammatone_iir_spectrogram",
    "MdctParams",
    "mdct",
    "imdct",
    "compute_mdct",
    "compute_imdct",
    "griffin_lim",
    "mel_to_linear",
    "invert_mel_db",
    "mel_filterbank_pinv",
    "plan_constants_from_numpy",
    "FeatureSet",
    "FeaturePipeline",
    "FeatureBatch",
    "FeatureSetBatch",
    "runtime",
    "fft_plan_cache_info",
    "clear_fft_plan_cache",
    "cache_stats",
] + [name for name in _functions_all if name not in ("fft_plan_cache_info", "clear_fft_plan_cache")]
