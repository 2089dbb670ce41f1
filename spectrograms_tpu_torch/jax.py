"""JAX interop without JAX (counterpart of ``spectrograms_tpu.jax``).

This package imports no JAX, so it cannot make a ``jax.Array``. ``to_jax``
returns the result's tensor, detached and contiguous, which exports DLPack:
a caller who has JAX finishes with ``jax.numpy.from_dlpack(to_jax(result))``.
JAX's ``device=``/``dtype=`` arguments need JAX to honour them, so they
raise here. Importing this module patches ``.to_jax`` onto every result
class, as the JAX module does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .binaural import IldSpectrogram, IlrSpectrogram, IpdSpectrogram, ItdSpectrogram
from .chroma import Chromagram
from .cqt import CqtResult
from .dtypes import result_data
from .errors import InvalidInputError
from .mfcc import Mfcc
from .parallel.batching import batch, batch_with_metadata, result_metadata
from .pipeline import Spectrogram, StftResult

__all__ = ["to_jax", "JaxSpectrogram", "batch", "batch_with_metadata"]


@dataclass
class JaxSpectrogram:
    """The DLPack-ready tensor + the metadata of the source result."""

    array: Any
    frequencies: Optional[np.ndarray] = None
    times: Optional[np.ndarray] = None
    params: Any = None
    db_range: Optional[Tuple[float, float]] = None

    @property
    def shape(self):
        return tuple(self.array.shape)

    @property
    def dtype(self):
        return self.array.dtype


def to_jax(result, device=None, dtype=None, with_metadata: bool = False):
    """Result → its tensor, detached and contiguous, for
    ``jax.numpy.from_dlpack`` (optionally wrapped with the metadata).
    Raises on ``device``/``dtype``: move or cast with JAX after the import."""
    if device is not None or dtype is not None:
        raise InvalidInputError(
            "to_jax(device=, dtype=) needs JAX, which spectrograms_tpu_torch does not "
            "import: call jax.numpy.from_dlpack(to_jax(result)) and move or cast there"
        )
    arr = torch.as_tensor(result_data(result)).detach().contiguous()
    if not with_metadata:
        return arr
    return JaxSpectrogram(arr, **result_metadata(result))


def _patch():
    for cls in (Spectrogram, StftResult, Mfcc, Chromagram, CqtResult,
                ItdSpectrogram, IpdSpectrogram, IldSpectrogram, IlrSpectrogram):
        cls.to_jax = (
            lambda self, device=None, dtype=None, with_metadata=False: to_jax(
                self, device, dtype, with_metadata
            )
        )


_patch()
