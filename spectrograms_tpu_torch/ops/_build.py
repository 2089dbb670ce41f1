"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/spectrograms_tpu_torch/lib<name>_<hash>.so`` beside the package;
the hash covers the source and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. This takes seconds, where a source that
includes PyTorch's headers (``torch.utils.cpp_extension.load``) takes minutes.
Nothing is built when the package is imported: only the first launch builds,
or ``build_all``/``build_kernels``, which start one ``nvcc`` per source, all
together.

``SOURCES`` is the one table of how each source is called: the ctypes
signatures of its two C entries, its library, loaded at first use, and
``Source.launch``, the one call through which every launch goes, which
counts the launch in the ``.launches`` of the source's ``counter``: the
object that the module owning the source names there when it is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..errors import FftBackendError

__all__ = ["SOURCES", "Source", "load_library", "build_all", "build_kernels", "find_nvcc",
           "build_log", "launch_counts", "add_launches", "BUILD_DIR", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spectrograms_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
# source name -> (build seconds, nvcc's output: ptxas registers/spills)
build_log: dict = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` or ``/usr/local/cuda/bin/nvcc``."""
    roots = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for root in roots:
        if root and os.access(Path(root) / "bin" / "nvcc", os.X_OK):
            return str(Path(root) / "bin" / "nvcc")
    raise FftBackendError(
        "nvcc not found (looked in $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the fused CUDA kernel is compiled at first use and needs the CUDA "
        "toolkit; set CUDA_HOME to its root"
    )


def _library_path(name: str) -> tuple:
    """(source, shared library) of ``csrc/<name>.cu``; the library's name
    carries a hash of the source and the flags."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one ``nvcc`` each, all started together; raise if any fails."""
    with _lock:
        todo = [(name, *_library_path(name)) for name in names]
        todo = [(name, src, so) for name, src, so in todo if not so.exists()]
        if not todo:
            return
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        jobs = []
        for name, src, so in todo:
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, src, so, tmp, proc))
        failed = []
        for name, src, so, tmp, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building {src.name}:\n{log}")
                continue
            os.replace(tmp, so)
            build_log[name] = (time.perf_counter() - t0, log)
        if failed:
            raise FftBackendError("\n".join(failed))


def build_kernels(names) -> None:
    """Build and load the named sources (``run.source`` of a runner)
    without launching them: one ``nvcc`` each, all started together; a
    built source is loaded as it is."""
    names = sorted(set(names))
    build_all(names)
    for name in names:
        load_library(name)


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, its entries typed by
    ``SOURCES[name]``."""
    source = SOURCES[name]
    if source.lib is not None:
        return source.lib
    build_all([name])
    with _lock:
        if source.lib is None:
            source.lib = source.bind(ctypes.CDLL(str(_library_path(name)[1])))
        return source.lib


class Source:
    """One ``csrc/<name>.cu``: the ctypes signatures of its C entries
    ``<name>_launch`` (its arguments, then the stream) and
    ``<name>_error_string``; ``lib``, its library once loaded;
    ``counter``, whose ``.launches`` counts its launches (set by the
    module that owns the source); and ``launch``, the one call that
    launches it. Pointers and streams are ``ctypes.c_void_p``, so 64-bit
    addresses survive."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.signatures = {
            f"{name}_launch": ([*argtypes, ctypes.c_void_p], ctypes.c_int),
            f"{name}_error_string": ([ctypes.c_int], ctypes.c_char_p),
        }
        self.lib = None
        self.counter = None

    def bind(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        """Type ``lib``'s entries (this source's library, or another build
        of it) by this source's signatures; returns ``lib``."""
        for fn, (argtypes, restype) in self.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        return lib

    def launch(self, device: torch.device, *args, lib=None) -> None:
        """Call ``<name>_launch(*args, stream)`` on ``device``'s current
        stream; raise ``FftBackendError`` on a non-zero return. A launch of
        the source's own library that returns 0 is counted; one of another
        build (``lib``, a stage variant) is not."""
        own = lib is None
        if own:
            lib = self.lib or load_library(self.name)
        dev = device.index
        # the current stream's handle, without building a torch.cuda.Stream (~6 us a call)
        args = (*args, torch._C._cuda_getCurrentRawStream(dev))
        entry = getattr(lib, self.name + "_launch")
        # The C entry launches on the current device: a guard only when the tensors are elsewhere.
        if dev == torch.cuda.current_device():
            rc = entry(*args)
        else:
            with torch.cuda.device(device):
                rc = entry(*args)
        if rc != 0:
            msg = getattr(lib, self.name + "_error_string")(rc).decode()
            raise FftBackendError(f"{self.name} kernel launch failed: {msg} ({rc})")
        if own:
            self.counter.launches += 1


_P, _I, _LL, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                      ctypes.c_double)

# every csrc source: its launch entry's arguments before the stream
SOURCES = {source.name: source for source in (
    Source("fused_features", [_P] * 8 + [_I, _LL] + [_I] * 9 + [_F] + [_I] * 3),
    Source("fused_tier_features", [_P] * 17 + [_I, _LL] + [_I] * 23 + [_F]),
    Source("delta", [_P, _P, _LL] + [_I] * 9),
    Source("mdct", [_P] * 3 + [_LL] + [_I] * 4),
    Source("griffin_lim", [_P, _P, _LL] + [_P] * 5 + [_LL, _I, _I, _I, _F, _I]),
    Source("gammatone", [_P] * 5 + [_LL, _LL] + [_I] * 7 + [_D]),
)}


def launch_counts() -> tuple:
    """Every source's ``.launches``, in ``SOURCES``' order."""
    return tuple(source.counter.launches for source in SOURCES.values())


def add_launches(counts, sign: int = 1) -> None:
    """Add ``sign * counts`` (in ``SOURCES``' order) to the sources' ``.launches``."""
    for source, n in zip(SOURCES.values(), counts):
        source.counter.launches += sign * n
