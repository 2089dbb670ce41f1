"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/spectrograms_tpu_torch/lib<name>_<hash>.so`` beside the package;
the hash covers the source and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. This takes seconds, where a source that
includes PyTorch's headers (``torch.utils.cpp_extension.load``) takes minutes.
Nothing is built when the package is imported: only the first launch builds.
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

__all__ = ["load_library", "find_nvcc", "build_log", "BUILD_DIR", "NVCC_FLAGS"]

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


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.

    ``signatures`` maps each C function to ``(argtypes, restype)``; pointers
    and streams must be ``ctypes.c_void_p`` so 64-bit addresses survive.
    """
    with _lock:
        if name in _libs:
            return _libs[name]
        src = _CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}_{digest}.so"
        if not so.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise FftBackendError(
                    f"nvcc failed ({proc.returncode}) building {src.name}:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so)
            build_log[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib
