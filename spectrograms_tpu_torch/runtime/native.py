"""ctypes binding to the host library ``native/sgtpu.cpp``.

Counterpart of ``spectrograms_tpu.runtime.native``: the same C entry points
(WAV codec, ring-buffer framer, prefetching loader, resampler), built from
the same source, which the port compiles as it stands. The library is built
by ``g++`` at first use into ``build/spectrograms_tpu_torch/`` beside the
package, under a name that carries a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one loaded as it is. Parallel
processes (test workers, the JAX package's own build in ``native/build/``)
cannot race: a build holds a file lock, compiles to a temporary name and
moves the result into place with ``os.replace``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["NativeUnavailable", "native_available", "load_library", "build_library"]

_SRC = Path(__file__).resolve().parents[2] / "native" / "sgtpu.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spectrograms_tpu_torch"
_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


class NativeUnavailable(RuntimeError):
    """The sgtpu native library cannot be built or loaded."""


def library_path() -> Path:
    """Where the library of the current source and flags is built, in
    ``BUILD_DIR``."""
    if not _SRC.exists():
        raise NativeUnavailable(f"native source not found: {_SRC}")
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsgtpu_{digest}.so"


def build_library(force: bool = False) -> Path:
    """Compile ``native/sgtpu.cpp`` with ``g++`` into ``BUILD_DIR`` unless
    it is built already.

    Safe across processes: the build holds ``BUILD_DIR/libsgtpu.lock``,
    writes a temporary file and renames it, so a reader sees either no
    library or a whole one.
    """
    so = library_path()
    if so.exists() and not force:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "libsgtpu.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and not force:  # another process built it meanwhile
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                                  capture_output=True, text=True)
        except OSError as e:
            raise NativeUnavailable(f"cannot run g++: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeUnavailable(f"g++ failed:\n{proc.stderr}")
        os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i64p, i32p = c.POINTER(c.c_int64), c.POINTER(c.c_int32)
    sig = {
        "sg_last_error": ([], c.c_char_p),
        "sg_free": ([c.c_void_p], None),
        "sg_wav_read": ([c.c_char_p, c.POINTER(c.POINTER(c.c_float)), i64p, i32p, i32p],
                        c.c_int),
        "sg_wav_write": ([c.c_char_p, c.POINTER(c.c_float), c.c_int64, c.c_int32, c.c_int32,
                          c.c_int32], c.c_int),
        "sg_framer_new": ([c.c_int64, c.c_int64, c.c_int64], c.c_void_p),
        "sg_framer_free": ([c.c_void_p], None),
        "sg_framer_space": ([c.c_void_p], c.c_int64),
        "sg_framer_available": ([c.c_void_p], c.c_int64),
        "sg_framer_push": ([c.c_void_p, c.POINTER(c.c_float), c.c_int64], c.c_int64),
        "sg_framer_pop": ([c.c_void_p, c.POINTER(c.c_float), c.c_int64], c.c_int64),
        "sg_framer_flush": ([c.c_void_p, c.POINTER(c.c_float)], c.c_int32),
        "sg_loader_free": ([c.c_void_p], None),
        "sg_loader_release": ([c.c_void_p, c.c_int64], None),
        "sg_resample": ([c.POINTER(c.c_float), c.c_int64, c.c_double, c.c_double,
                         c.POINTER(c.c_float), c.c_int64], c.c_int64),
        # float32 rows; sg_loader_new2 adds the mode: 0 float32 rows, 1 int16
        # PCM rows, 2 μ-law bytes (runtime/ulaw.py)
        "sg_loader_new": ([c.POINTER(c.c_char_p), c.c_int64, c.c_int64, c.c_int64, c.c_int32,
                           c.c_int32], c.c_void_p),
        "sg_loader_new2": ([c.POINTER(c.c_char_p), c.c_int64, c.c_int64, c.c_int64, c.c_int32,
                            c.c_int32, c.c_int32], c.c_void_p),
    }
    for suffix, sample, decode in (("", c.c_float, ""), ("_i16", c.c_int16, "_i16"),
                                   ("_u8", c.c_uint8, "_ulaw")):
        sp = c.POINTER(sample)
        sig[f"sg_loader_next{suffix}"] = ([c.c_void_p, sp, i64p, i32p, i64p], c.c_int64)
        sig[f"sg_loader_acquire{suffix}"] = (
            [c.c_void_p, i64p, c.POINTER(sp), c.POINTER(i64p), c.POINTER(i32p),
             c.POINTER(i64p)], c.c_int64)
        sig[f"sg_wav_decode_into{decode}"] = ([c.c_char_p, sp, c.c_int64, i32p], c.c_int64)
    for name, (argtypes, restype) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def load_library(build_if_missing: bool = True) -> ctypes.CDLL:
    """Load the native library, building it on first use.

    Raises :class:`NativeUnavailable` when it cannot be built or loaded.
    With ``build_if_missing=False`` nothing is built: a library that is not
    built yet raises, and so does every call after a failed load.
    """
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed and not build_if_missing:
            raise NativeUnavailable("native library previously failed to load")
        try:
            if build_if_missing:
                path = build_library()
            else:
                path = library_path()
                if not path.exists():
                    raise NativeUnavailable(f"{path.name} not built")
            _lib = _bind(ctypes.CDLL(str(path)))
            return _lib
        except (OSError, NativeUnavailable) as e:
            _load_failed = True
            raise NativeUnavailable(str(e)) from e


def native_available() -> bool:
    """True if the native library loads (building it if needed)."""
    try:
        load_library()
        return True
    except NativeUnavailable:
        return False
