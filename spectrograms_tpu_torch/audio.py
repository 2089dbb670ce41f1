"""Audio-domain namespace (``spectrograms::audio``, lib.rs:286-293): the
spectrogram engine, windows, chroma, CQT, ERB and MFCC in one import.
Counterpart of ``spectrograms_tpu.audio``."""

from .chroma import *  # noqa: F401,F403
from .cqt import *  # noqa: F401,F403
from .erb import (  # noqa: F401
    ErbFilterbank,
    gammatone_center_frequencies,
    gammatone_iir_spectrogram,
)
from .mfcc import Mfcc, MfccPlan, compute_mfcc, delta, mfcc, mfcc_from_log_mel  # noqa: F401
from .pipeline import (  # noqa: F401
    AmpScale,
    FreqScale,
    Spectrogram,
    SpectrogramPlan,
    SpectrogramPlanner,
    StftPlan,
    StftResult,
)
from .plans import *  # noqa: F401,F403
from .params import (  # noqa: F401
    ChromaNorm,
    ChromaParams,
    CqtParams,
    ErbParams,
    ErbSpacing,
    GammatoneParams,
    LogHzParams,
    LogParams,
    MelNorm,
    MelParams,
    MfccParams,
    SpectrogramParams,
    StftParams,
)
from .windows import (  # noqa: F401
    WindowType,
    make_window,
    parse_window,
)
from .reconstruct import griffin_lim, invert_mel_db, mel_to_linear  # noqa: F401
