"""Precision, dtype and device handling for the PyTorch port.

Counterpart of ``spectrograms_tpu.dtypes``. Constants (windows, filterbanks,
DFT/DCT matrices) are built in float64 NumPy and cast at the edge; compute
runs in the plan's torch dtype on the plan's device.

- ``parse_dtype`` returns a ``torch.dtype``; bfloat16 is ``torch.bfloat16``.
- ``Precision`` replaces ``jax.lax.Precision`` and keeps its meaning: a
  ``method="pallas"`` plan rejects ``HIGHEST`` and ``method="auto"`` avoids
  the fused kernels under it; on the fused route ``DEFAULT`` runs the 1-pass
  bf16 tier on tensor cores, as the JAX package does on the MXU, and
  ``HIGH`` the f32 kernel, at least as precise as the bf16x3 tier. The
  port's plain paths always run in true f32 (``check_true_f32``).
- ``resolve_device`` maps ``device=None`` to CUDA and raises when CUDA is
  absent: an entry point never quietly runs on the CPU.
- ``set_default_dtype`` changes what ``dtype=None`` means (float32 unless
  set); ``complex_dtype`` gives the STFT's complex dtype; ``dlpack_export``
  backs the result classes' ``__dlpack__``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .errors import InvalidInputError

__all__ = [
    "DEFAULT_DTYPE",
    "Precision",
    "parse_dtype",
    "set_default_dtype",
    "get_default_dtype",
    "complex_dtype",
    "ensure_x64",
    "dlpack_export",
    "numpy_dtype",
    "ensure_plan_dtype",
    "real_dtype_name",
    "resolve_device",
    "check_true_f32",
    "check_precision",
    "result_data",
]

# The framework default, as in the JAX package (the reference crate's is f64).
DEFAULT_DTYPE = torch.float32

_ALIASES = {
    "float32": torch.float32,
    "f32": torch.float32,
    "float64": torch.float64,
    "f64": torch.float64,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}

_TO_NUMPY = {torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64)}

_default_dtype = DEFAULT_DTYPE


class Precision(enum.Enum):
    """Matmul precision request, the port's ``jax.lax.Precision``."""

    DEFAULT = "default"
    HIGH = "high"
    HIGHEST = "highest"


def parse_dtype(dtype=None) -> torch.dtype:
    """Parse a dtype spec ("float32"/"f32"/"float64"/"f64"/"bfloat16"/…).

    Accepts strings, torch dtypes, numpy dtypes and python float types.
    ``None`` gives the default (float32; see :func:`set_default_dtype`).
    """
    if dtype is None:
        return _default_dtype
    if isinstance(dtype, torch.dtype):
        if not dtype.is_floating_point:
            raise InvalidInputError(f"unsupported dtype {dtype!r}: must be floating")
        return dtype
    if isinstance(dtype, str):
        key = dtype.strip().lower()
        if key in _ALIASES:
            return _ALIASES[key]
        raise InvalidInputError(
            f"unsupported dtype {dtype!r}; expected one of {sorted(_ALIASES)}"
        )
    try:
        dt = np.dtype(dtype)
    except TypeError as e:
        raise InvalidInputError(f"unsupported dtype {dtype!r}") from e
    if dt.kind != "f" or dt.name not in _ALIASES:
        raise InvalidInputError(f"unsupported dtype {dtype!r}: must be float32/float64")
    return _ALIASES[dt.name]


def set_default_dtype(dtype) -> None:
    """Set the dtype used when ``dtype=None`` (framework default: float32).

    ``set_default_dtype("float64")`` restores the reference crate's default
    precision, as in the JAX package.
    """
    global _default_dtype
    dt = parse_dtype(dtype)
    ensure_x64(dt)
    _default_dtype = dt


def get_default_dtype() -> torch.dtype:
    """The dtype used when ``dtype=None``."""
    return _default_dtype


def complex_dtype(real_dtype) -> torch.dtype:
    """Complex counterpart of a real dtype (bf16/f32 → complex64, f64 → complex128)."""
    return torch.complex128 if parse_dtype(real_dtype) == torch.float64 else torch.complex64


def ensure_x64(dtype) -> None:
    """Kept for the JAX package's surface, where it raises when float64 is
    asked for without jax's x64 mode. PyTorch computes in float64 natively,
    so there is nothing to check."""


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """NumPy counterpart of a float32/float64 torch dtype."""
    if dtype not in _TO_NUMPY:
        raise InvalidInputError(f"{dtype} has no NumPy counterpart here")
    return _TO_NUMPY[dtype]


def ensure_plan_dtype(dtype) -> None:
    """Plans compute in float32 or float64 only (as in the JAX package)."""
    if dtype not in (torch.float32, torch.float64):
        raise InvalidInputError(f"plans compute in float32/float64, got {dtype}")


def real_dtype_name(dtype) -> str:
    """Real-precision dtype name of possibly-complex data ("float32"/"float64")."""
    names = {torch.complex64: "float32", torch.complex128: "float64"}
    return names.get(dtype, str(dtype).removeprefix("torch."))


def resolve_device(device=None) -> torch.device:
    """The device a plan computes on: ``None`` means CUDA.

    Raises when the device is CUDA and no card is visible; pass
    ``device="cpu"`` to run the plain PyTorch paths on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise InvalidInputError(
                "CUDA is not available; spectrograms_tpu_torch computes on the "
                "GPU by default — pass device='cpu' to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_true_f32() -> None:
    """Raise if TF32 matmuls are enabled.

    The plain paths' float32 matmuls must be true f32, as the JAX package's
    HIGH/HIGHEST references are: TF32 keeps ~3 decimal digits and would move
    dB values by far more than the tolerances the port is held to. PyTorch's
    default (``torch.backends.cuda.matmul.allow_tf32 == False``, precision
    "highest") is required; the port never enables TF32 itself.
    """
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise InvalidInputError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul.allow_tf32 or "
            "set_float32_matmul_precision); the port's float32 paths require "
            "true f32 matmuls"
        )


def check_precision(precision) -> None:
    """Accept ``None`` or a :class:`Precision`: the JAX package's precision
    argument of the standalone CQT and MDCT, which changes no arithmetic
    here (their products are true f32 or f64)."""
    if precision is not None and not isinstance(precision, Precision):
        raise InvalidInputError(f"precision must be a Precision, got {precision!r}")


def dlpack_export(data: torch.Tensor, stream=None, max_version=None, dl_device=None,
                  copy=None):
    """Array-API ``__dlpack__`` backing for the result classes.

    Validates the arguments as the JAX package's ``dlpack_export`` does (the
    same ``BufferError`` texts), then exports through
    ``torch.Tensor.__dlpack__``. The data is detached first: DLPack carries
    no autograd graph.
    """
    data = data.detach()
    dev = data.__dlpack_device__()
    if stream is not None and dev[0] == 1:  # kDLCPU
        raise BufferError("stream must be None for CPU tensors")
    if max_version is not None:
        major = max_version[0]
        if major < 1:
            raise BufferError(f"Unsupported DLPack version: {max_version[0]}.{max_version[1]}")
    if dl_device is not None and tuple(dl_device) != tuple(dev):
        if dev[0] == 1:
            raise BufferError(f"Only CPU device (1, 0) is supported, got {tuple(dl_device)}")
        raise BufferError(f"Unsupported DLPack device {tuple(dl_device)}")
    if copy:
        data = data.clone()
    kwargs = {} if max_version is None else {"max_version": tuple(max_version)}
    if stream is not None:
        return data.__dlpack__(stream=stream, **kwargs)
    return data.__dlpack__(**kwargs)


def result_data(obj):
    """The array of a result object (``.data``), or ``obj`` itself when it is
    already an array or tensor (a numpy array's ``.data`` is its buffer)."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj
    return getattr(obj, "data", obj)
