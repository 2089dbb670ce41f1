"""Signal framing with ``centre`` semantics, in torch.

Counterpart of ``spectrograms_tpu.ops.framing`` with the same index
arithmetic (the reference's framing policy, ``src/spectrogram.rs:1230-1337``):

- ``centre=True``: the signal is *virtually* padded with ``n_fft//2`` zeros on
  both sides; frame ``i`` covers virtual samples ``[i*hop, i*hop + n_fft)``.
- ``centre=False``: no padding.
- frame count: ``1`` if the (padded) signal is shorter than ``n_fft``, else
  ``(padded_len - n_fft) // hop + 1``.

Every function takes leading batch dimensions: the JAX package's ``vmap``
becomes an explicit batch axis here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..errors import InvalidInputError

__all__ = [
    "frame_count",
    "pad_amounts",
    "frame_signal",
    "framed_matmul",
    "tail_framed_matmul",
    "frame_start_sample",
]

# Above this many partial products the hopped decomposition of
# framed_matmul loses to one frame matrix and one matmul (same cap as the
# JAX package; typical hops give k = 2..8).
_FRAMED_MATMUL_MAX_K = 8


def frame_count(n_samples: int, n_fft: int, hop_size: int, centre: bool) -> int:
    """Number of STFT frames for a signal of ``n_samples``.

    Examples
    --------
    >>> from spectrograms_tpu_torch.ops.framing import frame_count
    >>> frame_count(16000, 1024, 256, True)   # centre pads n_fft//2 each side
    63
    >>> frame_count(16000, 1024, 256, False)
    59
    """
    if n_samples <= 0:
        raise InvalidInputError("signal must be non-empty")
    pad = n_fft // 2 if centre else 0
    padded_len = n_samples + 2 * pad
    if padded_len < n_fft:
        return 1
    return (padded_len - n_fft) // hop_size + 1


def pad_amounts(n_samples: int, n_fft: int, hop_size: int, centre: bool):
    """(left_pad, right_pad, n_frames) so every frame reads in-bounds.

    ``right_pad`` covers both the virtual centre padding and the case where a
    single partial frame extends past the padded signal end.
    """
    n_frames = frame_count(n_samples, n_fft, hop_size, centre)
    pad = n_fft // 2 if centre else 0
    last_end = (n_frames - 1) * hop_size + n_fft  # in virtual indices
    right = max(0, last_end - pad - n_samples)
    return pad, right, n_frames


def frame_start_sample(frame_idx: int, n_fft: int, hop_size: int, centre: bool) -> int:
    """Signal-domain index of a frame's first sample (may be negative)."""
    pad = n_fft // 2 if centre else 0
    return frame_idx * hop_size - pad


def frame_signal(x: torch.Tensor, n_fft: int, hop_size: int, centre: bool = True):
    """(..., n) signal → (..., n_frames, n_fft) frame matrix.

    The result is a strided view of one zero-padded copy of the signal
    (``Tensor.unfold``); consumers that need it contiguous copy it.
    """
    left, right, n_frames = pad_amounts(x.shape[-1], n_fft, hop_size, centre)
    xp = F.pad(x, (left, right))
    return xp.unfold(-1, n_fft, hop_size)[..., :n_frames, :]


def framed_matmul(x: torch.Tensor, mat: torch.Tensor, n_fft: int, hop_size: int,
                  centre: bool = True):
    """``frame_signal(x, …) @ mat`` without a frame matrix in memory.

    When ``hop | n_fft`` (and ``k = n_fft//hop`` is small) the frame matrix
    is ``k`` hop-strided slices of one reshape laid side by side, so

        frames @ M  ==  Σ_j  X_j @ M[j·hop : (j+1)·hop]

    where each ``X_j`` is a view of the padded signal with contiguous rows.
    Other hops build the frame matrix and take one matmul. ``mat`` is
    (n_fft, n_out); returns (..., n_frames, n_out) in the promoted dtype of
    ``x`` and ``mat`` (``jnp.promote_types``), the products taken in at
    least float32.
    """
    out_dtype = torch.promote_types(x.dtype, mat.dtype)
    acc_dtype = torch.promote_types(out_dtype, torch.float32)
    x, mat = x.to(acc_dtype), mat.to(acc_dtype)
    if n_fft % hop_size == 0 and 1 < n_fft // hop_size <= _FRAMED_MATMUL_MAX_K:
        left, right, n_frames = pad_amounts(x.shape[-1], n_fft, hop_size, centre)
        k = n_fft // hop_size
        # Pad so the (cols, hop) reshape covers every frame's last slice:
        # frame i is rows [i, i+k) of it.
        need = (n_frames - 1 + k) * hop_size
        extra = max(0, need - (x.shape[-1] + left + right))
        xp = F.pad(x, (left, right + extra))
        cols = xp.shape[-1] // hop_size
        base = xp[..., : cols * hop_size].reshape(*x.shape[:-1], cols, hop_size)
        out = None
        for j in range(k):
            part = base[..., j : j + n_frames, :] @ mat[j * hop_size : (j + 1) * hop_size]
            out = part if out is None else out + part
        return out.to(out_dtype)
    return (frame_signal(x, n_fft, hop_size, centre) @ mat).to(out_dtype)


def tail_framed_matmul(x: torch.Tensor, mat: torch.Tensor, n_fft: int, hop_size: int, s: int,
                       centre: bool = True):
    """``frame_signal(x, n_fft, hop, centre)[..., n_fft−s:] @ mat``.

    Contracts only the last ``s`` samples of every frame against ``mat``
    ((s, n_out)): the banded-CQT primitive, where right-aligned kernels
    shorter than the frame leave the leading columns structural zeros.
    Framing (count, padding) is that of the full ``n_fft`` frames.

    Without a frame matrix for ``s % hop == 0`` (the hopped decomposition of
    :func:`framed_matmul` on the tail-shifted signal) and ``hop % s == 0``
    (strided row slices of one reshape, ``s == hop`` included); other
    shapes build the (n_frames, s) frames.
    """
    if s == n_fft:
        return framed_matmul(x, mat, n_fft, hop_size, centre)
    if not 0 < s < n_fft:
        raise InvalidInputError(f"support must be in (0, n_fft], got {s}")
    n = x.shape[-1]
    left, right, n_frames = pad_amounts(n, n_fft, hop_size, centre)
    off = n_fft - s
    end = off + (n_frames - 1) * hop_size + s
    extra = max(0, end - (n + left + right))
    y = F.pad(x, (left, right + extra))[..., off:end]  # the first frame's tail starts at y[0]
    if s % hop_size == 0 and s > hop_size:
        return framed_matmul(y, mat, s, hop_size, centre=False)
    if hop_size % s == 0:
        step = hop_size // s
        rows = (n_frames - 1) * step + 1
        frames = y.reshape(*y.shape[:-1], rows, s)[..., ::step, :]
    else:
        frames = frame_signal(y, s, hop_size, centre=False)
    out_dtype = torch.promote_types(x.dtype, mat.dtype)
    return frames.to(out_dtype) @ mat.to(out_dtype)
