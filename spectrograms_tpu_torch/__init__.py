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

The 1-D/2-D FFT and image family: ``fft_convolve``/``fft_deconvolve`` and
the streaming ``OverlapSaveConvolver`` (``convolution.py``),
``minimum_phase`` (``min_phase.py``), ``fft2d`` and its helpers
(``fft2d.py``), the FFT image filters (``image_ops.py``, with the dense
DFT-product route of ``ops/spectral2d.py``); ``fft`` and ``image`` are the
namespace modules (``fft`` is callable, so ``fft(x, n)`` works whether the
name is the function or the module). The f64-grade tier: ``method="f32x2"``
plans and ``stft_x2``/``istft_x2``/``fft2d_x2``/``ifft2d_x2`` (``x2.py``),
computed in float64 on the card and split into (hi, lo) float32 pairs,
with the JAX package's double-double arithmetic in ``ops/dd.py``;
``method="factored"`` runs the two-stage rFFT of ``ops/fft_factored.py``.

Serving: ``FeaturePipeline`` reads WAV files (or decoded arrays) through
the native loader (``runtime/``, a ctypes binding to ``native/sgtpu.cpp``),
ships them as float32, int16 or μ-law and returns per-batch features with
frame masks; ``FeatureSet`` runs several plans over one batch, sharing the
multirate plans' decimation (``ops/decimate.py``). ``autotune_plan`` picks
a plan's ``method=`` by measuring it on the device and remembers the
winner (``autotune.py``); ``parallel`` holds device meshes, sharded batches
and the halo-exchange sequence parallelism behind
``FeaturePipeline(mesh=…)``.

Also: binaural ITD/IPD/ILD/ILR analysis (``binaural.py``), the
``SpectrogramSource`` protocol and its sources (``source.py``), and
``serde`` (JSON and NPZ files that load in either package).
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
from .convolution import fft_convolve, fft_deconvolve, OverlapSaveConvolver
from .min_phase import minimum_phase, minimum_phase_with
from .reconstruct import griffin_lim, mel_to_linear, invert_mel_db, mel_filterbank_pinv
from .fft2d import (
    fft2d,  # rebinds the package attribute from the module to the function, as in JAX
    fft2d as compute_fft2d,
    ifft2d,
    power_spectrum_2d,
    magnitude_spectrum_2d,
    fftshift,
    ifftshift,
    fftshift_1d,
    ifftshift_1d,
    fftfreq,
    rfftfreq,
    Fft2dPlanner,
)
from . import image_ops
from .image_ops import (
    convolve_fft,
    gaussian_kernel_2d,
    lowpass_filter,
    highpass_filter,
    bandpass_filter,
    detect_edges_fft,
    sharpen_fft,
)
from .x2 import stft_x2, istft_x2, fft2d_x2, ifft2d_x2
from .convert import plan_constants_from_numpy
from .featureset import FeatureSet
from .serving import FeatureBatch, FeatureSetBatch, FeaturePipeline
from . import runtime
from .cache import fft_plan_cache_info, clear_fft_plan_cache, cache_stats
from .binaural import (
    magphase,
    ITDSpectrogramParams,
    IPDSpectrogramParams,
    ILDSpectrogramParams,
    ILRSpectrogramParams,
    ItdSpectrogram,
    IpdSpectrogram,
    IldSpectrogram,
    IlrSpectrogram,
    compute_itd_spectrogram,
    compute_ipd_spectrogram,
    compute_ild_spectrogram,
    compute_ilr_spectrogram,
    compute_itd_spectrogram_diff,
    compute_ilr_spectrogram_diff,
    compute_itd_spectrogram_batch,
    compute_ipd_spectrogram_batch,
    compute_ild_spectrogram_batch,
    compute_ilr_spectrogram_batch,
)
from .source import (
    SpectrogramSource,
    PlanSource,
    GammatoneSource,
    CqtSource,
    ChromaSource,
    MfccSource,
)
from . import parallel
from . import serde
from .autotune import (
    AutotuneResult,
    autotune,
    autotune_plan,
    wisdom,
    clear_wisdom,
    save_wisdom,
    load_wisdom,
)

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
    "fft_convolve",
    "fft_deconvolve",
    "OverlapSaveConvolver",
    "minimum_phase",
    "minimum_phase_with",
    "fft2d",
    "compute_fft2d",
    "ifft2d",
    "power_spectrum_2d",
    "magnitude_spectrum_2d",
    "fftshift",
    "ifftshift",
    "fftshift_1d",
    "ifftshift_1d",
    "fftfreq",
    "rfftfreq",
    "Fft2dPlanner",
    "image_ops",
    "convolve_fft",
    "gaussian_kernel_2d",
    "lowpass_filter",
    "highpass_filter",
    "bandpass_filter",
    "detect_edges_fft",
    "sharpen_fft",
    "stft_x2",
    "istft_x2",
    "fft2d_x2",
    "ifft2d_x2",
    "plan_constants_from_numpy",
    "FeatureSet",
    "FeaturePipeline",
    "FeatureBatch",
    "FeatureSetBatch",
    "runtime",
    "fft_plan_cache_info",
    "clear_fft_plan_cache",
    "cache_stats",
    # binaural
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
    # sources
    "SpectrogramSource",
    "PlanSource",
    "GammatoneSource",
    "CqtSource",
    "ChromaSource",
    "MfccSource",
    "parallel",
    "serde",
    # autotune
    "AutotuneResult",
    "autotune",
    "autotune_plan",
    "wisdom",
    "clear_wisdom",
    "save_wisdom",
    "load_wisdom",
] + [name for name in _functions_all if name not in ("fft_plan_cache_info", "clear_fft_plan_cache")]
