"""Batching utilities: stacking result objects, ragged padding.

Counterpart of ``spectrograms_tpu.parallel.batching`` (the reference's
``spectrograms.jax`` helpers, python/spectrograms/jax.py:204-338):
``batch()`` stacks (n_bins, n_frames) results into (B, n_bins, n_frames),
optionally padding to the largest shape; ``batch_with_metadata`` keeps the
axes and params beside it. ``pad_signals`` is the input-side analog for
ragged utterances (pad to one shape, so that a fixed-shape step serves
variable lengths).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import resolve_device, result_data
from ..errors import InvalidInputError

__all__ = ["batch", "batch_with_metadata", "pad_signals"]


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, numpy or string dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def batch(spectrograms: List, device=None, dtype=None, pad: bool = False) -> torch.Tensor:
    """Stack spectrogram/chromagram results into (B, n_bins, n_frames) on
    ``device`` (CUDA unless ``device="cpu"``)."""
    if not spectrograms:
        raise InvalidInputError("Cannot batch empty list of spectrograms")
    dev = resolve_device(device)
    arrays = [torch.as_tensor(result_data(s)).to(dev) for s in spectrograms]
    if dtype is not None:
        arrays = [a.to(_torch_dtype(dtype)) for a in arrays]
    if pad:
        max_bins = max(a.shape[0] for a in arrays)
        max_frames = max(a.shape[1] for a in arrays)
        arrays = [F.pad(a, (0, max_frames - a.shape[1], 0, max_bins - a.shape[0]))
                  for a in arrays]
    else:
        shape = arrays[0].shape
        if not all(a.shape == shape for a in arrays):
            raise InvalidInputError(
                f"All spectrograms must have the same shape. "
                f"Got shapes: {[tuple(a.shape) for a in arrays]}. "
                f"Use pad=True to pad to the same size."
            )
    return torch.stack(arrays)


def result_metadata(result) -> dict:
    """A result's ``frequencies`` and ``times`` (host numpy), ``params``
    and ``db_range()``; None for what it lacks."""
    db_range = getattr(result, "db_range", None)
    return {
        "frequencies": np.asarray(result.frequencies) if hasattr(result, "frequencies") else None,
        "times": np.asarray(result.times) if hasattr(result, "times") else None,
        "params": getattr(result, "params", None),
        "db_range": db_range() if callable(db_range) else None,
    }


def batch_with_metadata(
    spectrograms: List, device=None, dtype=None, pad: bool = False
) -> Tuple[torch.Tensor, List[dict]]:
    """Batch + per-item metadata dicts (shape/frequencies/times/params/db_range)."""
    metadata = []
    for spec in spectrograms:
        meta = {
            "shape": getattr(spec, "shape", None),
            "frequencies": np.asarray(spec.frequencies) if hasattr(spec, "frequencies") else None,
            "times": np.asarray(spec.times) if hasattr(spec, "times") else None,
            "params": getattr(spec, "params", None),
        }
        if hasattr(spec, "db_range") and callable(spec.db_range):
            meta["db_range"] = spec.db_range()
        metadata.append(meta)
    return batch(spectrograms, device=device, dtype=dtype, pad=pad), metadata


def pad_signals(
    signals: List,
    bucket_multiple: Optional[int] = None,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged utterances to one fixed shape → (batch (B, L), lengths (B,)),
    host numpy arrays.

    ``bucket_multiple`` rounds L up to a multiple (fewer distinct shapes).
    Use the returned lengths to mask padding frames downstream.
    """
    if not signals:
        raise InvalidInputError("Cannot pad an empty list of signals")
    arrays = [np.asarray(s.detach().cpu() if isinstance(s, torch.Tensor) else s,
                         dtype=dtype).ravel() for s in signals]
    lengths = np.asarray([a.shape[0] for a in arrays], dtype=np.int32)
    if any(n == 0 for n in lengths):
        raise InvalidInputError("signals must be non-empty")
    max_len = int(lengths.max())
    if bucket_multiple:
        max_len = -(-max_len // bucket_multiple) * bucket_multiple
    out = np.zeros((len(arrays), max_len), dtype=dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out, lengths
