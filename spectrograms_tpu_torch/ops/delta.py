"""Regression deltas along the last axis: the plain chain of torch ops and
the launch of ``csrc/delta.cu``, which computes every order in one launch.

``mfcc.delta`` (``tg.delta``) runs ``delta_reference`` on a CPU tensor and
``launch`` on a float32 or float64 CUDA tensor; the two are equal bit for
bit (the source's note says how). Both round the weights ``n / Σn²``,
computed in float64, to the features' type. ``launches`` counts the
kernel's launches (``_build.Source.launch`` adds to it).
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ..dtypes import numpy_dtype
from ..errors import InvalidInputError
from ._build import SOURCES

__all__ = ["delta_reference", "delta_weights", "launch", "layout", "kernel_dtype_code"]

# dtype -> the kernel's code (csrc/delta.cu::delta_launch)
_DTYPES = {torch.float32: 0, torch.float64: 1}

TILE = 1024                 # frames of a block's item; halved while shared memory overflows
MAX_GRID = 8192             # blocks; each loops over items beyond that
SMEM_MAX = 232448           # dynamic shared memory a block may use on sm_90

launches = 0                # kernel launches, counted as each returns
SOURCES["delta"].counter = sys.modules[__name__]


def kernel_dtype_code(dtype: torch.dtype) -> int:
    """The kernel's code of ``dtype``; raise on a dtype other than
    float32 and float64."""
    code = _DTYPES.get(dtype)
    if code is None:
        raise InvalidInputError(f"delta runs on float32 or float64 features, got {dtype}")
    return code


@functools.lru_cache(maxsize=64)
def delta_weights(width: int, dtype: torch.dtype) -> tuple:
    """librosa's weights ``n / Σn²`` for ``n = -width//2 .. width//2``,
    computed in float64 and rounded to ``dtype`` (float32 or float64; any
    other raises), as Python floats."""
    half = width // 2
    n = np.arange(-half, half + 1, dtype=np.float64)
    return tuple(float(v) for v in (n / np.sum(n * n)).astype(numpy_dtype(dtype)))


def delta_reference(x: torch.Tensor, width: int, order: int) -> torch.Tensor:
    """The plain version: edge replication by concatenation, then a sum of
    ``width`` scaled shifts, ``order`` times, in torch ops on ``x``'s device."""
    k = delta_weights(width, x.dtype)
    half = width // 2
    out = x
    for _ in range(order):
        fp = torch.cat([out[..., :1].expand(*out.shape[:-1], half), out,
                        out[..., -1:].expand(*out.shape[:-1], half)], dim=-1)
        # correlate along time: d[t] = sum_j k[j] f[t + j - half]
        out = sum(fp[..., i:i + out.shape[-1]] * k[i] for i in range(width))
    return out


@functools.lru_cache(maxsize=64)
def layout(T: int, width: int, order: int, dtype: torch.dtype, tile: int = TILE) -> tuple:
    """(tile, tiles a row, span, shared bytes) of a launch on rows of ``T``
    frames: the tile halves until the weights and the buffers (one at order
    1, two above, each of ``span = min(T, tile + 2·order·half)`` values of
    ``dtype``) fit in a block's shared memory."""
    size = 8 if dtype == torch.float64 else 4
    halo = order * (width // 2)
    nbuf = 1 if order == 1 else 2
    while True:
        span = min(T, tile + 2 * halo)
        smem = (width + nbuf * span) * size
        if smem <= SMEM_MAX or tile == 1:
            break
        tile //= 2
    if smem > SMEM_MAX:
        raise InvalidInputError(
            f"width {width} at order {order} needs a halo of {halo} frames a side: "
            f"{smem} bytes of shared memory, more than the kernel's {SMEM_MAX}")
    return tile, -(-T // tile), span, smem


def launch(x: torch.Tensor, width: int, order: int) -> torch.Tensor:
    """Launch ``csrc/delta.cu`` on a float32 or float64 CUDA tensor: one
    launch on the current stream, every order, counted in ``launches``; an
    empty tensor launches nothing."""
    code = kernel_dtype_code(x.dtype)
    if x.ndim == 0:
        raise InvalidInputError("delta needs at least one axis")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    T = x.shape[-1]
    if T >= 2**31:
        raise InvalidInputError(f"delta's kernel takes rows of fewer than 2**31 frames, got {T}")
    rows = x.numel() // T
    tile, tiles, span, smem = layout(T, width, order, x.dtype)
    SOURCES["delta"].launch(x.device, x.data_ptr(), out.data_ptr(), rows, T, width, order,
                            code, tile, tiles, span, smem, min(rows * tiles, MAX_GRID))
    return out
