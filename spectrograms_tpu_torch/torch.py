"""PyTorch interop (counterpart of ``spectrograms_tpu.torch``).

The port's results already hold torch tensors, so ``to_torch`` hands back a
result's ``data`` itself, the same storage, and moves or casts it only when
``device=`` or ``dtype=`` asks. Importing this module patches
``.to_torch(device=None, dtype=None, with_metadata=False)`` onto every
result class, as the JAX module does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .binaural import IldSpectrogram, IlrSpectrogram, IpdSpectrogram, ItdSpectrogram
from .chroma import Chromagram
from .cqt import CqtResult
from .dtypes import result_data
from .mfcc import Mfcc
from .parallel import batching as _batching
from .parallel.batching import result_metadata
from .pipeline import Spectrogram, StftResult

__all__ = ["to_torch", "batch", "batch_with_metadata", "TorchSpectrogram"]

@dataclass
class TorchSpectrogram:
    """Tensor + the axis/params metadata of the source result (the
    reference's metadata wrapper)."""

    tensor: Any
    frequencies: Optional[np.ndarray] = None
    times: Optional[np.ndarray] = None
    params: Any = None
    db_range: Optional[tuple] = None

    @property
    def shape(self):
        return tuple(self.tensor.shape)

    def _moved(self, tensor) -> "TorchSpectrogram":
        return TorchSpectrogram(tensor, self.frequencies, self.times, self.params, self.db_range)

    def to(self, device) -> "TorchSpectrogram":
        """Move the tensor to a device, keeping the metadata."""
        return self._moved(self.tensor.to(device))

    def cpu(self) -> "TorchSpectrogram":
        return self._moved(self.tensor.cpu())

    def cuda(self, device=None) -> "TorchSpectrogram":
        return self._moved(self.tensor.cuda(device) if device is not None else self.tensor.cuda())


def to_torch(result, device=None, dtype=None, with_metadata: bool = False):
    """A result's tensor (or a raw tensor/array as one): zero copy unless
    ``device``/``dtype`` (a torch dtype or its name) asks for a move or a
    cast. ``with_metadata=True`` wraps it in :class:`TorchSpectrogram`."""
    t = torch.as_tensor(result_data(result))
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if device is not None or dtype is not None:
        t = t.to(device=device, dtype=dtype)
    if not with_metadata:
        return t
    return TorchSpectrogram(t, **result_metadata(result))


def batch(results, device=None, dtype=None, pad: bool = False) -> torch.Tensor:
    """Stack result objects into one (B, n_bins, n_frames) tensor on
    ``device`` (CUDA unless ``device="cpu"``); ``pad=True`` pads ragged
    shapes with zeros."""
    return _batching.batch(results, device=device, dtype=dtype, pad=pad)


def batch_with_metadata(results, device=None, dtype=None, pad: bool = False):
    """:func:`batch` and the per-item metadata list."""
    return _batching.batch_with_metadata(results, device=device, dtype=dtype, pad=pad)


def _patch():
    for cls in (Spectrogram, StftResult, Mfcc, Chromagram, CqtResult,
                ItdSpectrogram, IpdSpectrogram, IldSpectrogram, IlrSpectrogram):
        cls.to_torch = (
            lambda self, device=None, dtype=None, with_metadata=False: to_torch(
                self, device, dtype, with_metadata
            )
        )


_patch()
