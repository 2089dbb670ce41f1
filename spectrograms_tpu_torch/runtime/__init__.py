"""Host-side native runtime: WAV IO, streaming framer, prefetching loader.

Counterpart of ``spectrograms_tpu.runtime``: a ctypes binding to the C++
library ``native/sgtpu.cpp`` (built by ``g++`` at first use, see
``native.py``) that decodes audio, frames streams and prefetches padded
batches on worker threads, keeping the card fed without holding the GIL.
Each entry point has a numpy fallback for hosts without a compiler.
"""

from .native import NativeUnavailable, native_available, load_library, build_library
from .wav import read_wav, write_wav
from .streaming import StreamingFramer, StreamingSpectrogram
from .loader import AudioBatchLoader

__all__ = [
    "NativeUnavailable",
    "native_available",
    "load_library",
    "build_library",
    "read_wav",
    "write_wav",
    "StreamingFramer",
    "StreamingSpectrogram",
    "AudioBatchLoader",
]
