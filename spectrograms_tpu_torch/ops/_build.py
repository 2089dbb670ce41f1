"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/spectrograms_tpu_torch/lib<name>_<hash>.so`` beside the package;
the hash covers the source and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. This takes seconds, where a source that
includes PyTorch's headers (``torch.utils.cpp_extension.load``) takes minutes.
Nothing is built when the package is imported: only the first launch builds,
or ``build_all``, which starts one ``nvcc`` per source, all together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from ..errors import FftBackendError

__all__ = ["load_library", "build_all", "find_nvcc", "build_log", "BUILD_DIR", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spectrograms_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict = {}
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


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.

    ``signatures`` maps each C function to ``(argtypes, restype)``; pointers
    and streams must be ``ctypes.c_void_p`` so 64-bit addresses survive.
    """
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = ctypes.CDLL(str(_library_path(name)[1]))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib
