"""Overlap-add, in torch.

Counterpart of ``spectrograms_tpu.ops.ola``. When ``hop`` divides ``n_fft``
(the usual 50 %/75 % overlaps) overlap-add is the framing reshape run in
reverse: each frame splits into ``k = n_fft//hop`` hop-chunks, and each
output hop-column is the sum of ≤ k shifted chunk lanes (pad and add, in the
JAX package's order). Other hops scatter with ``index_add``. Both take
leading batch dimensions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..errors import InvalidInputError

__all__ = ["overlap_add", "ola_matmul"]


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., n_frames, n_fft) → (..., (n_frames−1)·hop + n_fft) overlap-added signal."""
    *lead, nf, n_fft = frames.shape
    out_len = (nf - 1) * hop + n_fft
    if n_fft % hop == 0:
        k = n_fft // hop
        chunks = frames.reshape(*lead, nf, k, hop)
        acc = None
        for j in range(k):
            # Frame f's j-th chunk lands in output hop-column f + j.
            part = F.pad(chunks[..., j, :], (0, 0, j, k - 1 - j))
            acc = part if acc is None else part + acc
        return acc.reshape(*lead, -1)[..., :out_len]
    starts = torch.arange(nf, device=frames.device) * hop
    idx = (starts[:, None] + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    return frames.new_zeros(*lead, out_len).index_add(-1, idx, frames.reshape(*lead, nf * n_fft))


def ola_matmul(coeffs_t: torch.Tensor, mat: torch.Tensor, hop: int) -> torch.Tensor:
    """``overlap_add(coeffs_t @ mat, hop)`` without the frame matrix.

    Output hop-block ``b`` is ``Σ_j coeffs_t[b−j] @ mat[:, j·hop:(j+1)·hop]``:
    ``k = n_fft//hop`` matmuls against row-shifted views of the
    zero-row-padded coefficients, summed (the transpose of
    ``framing.framed_matmul``). ``coeffs_t`` is (..., n_frames, n_coef) and
    ``mat`` (n_coef, n_fft) with ``hop | n_fft``. Products and sums run in at
    least float32, as one dot of the JAX package does.
    """
    *lead, nf, _ = coeffs_t.shape
    n_fft = mat.shape[1]
    if n_fft % hop:
        raise InvalidInputError(f"ola_matmul requires hop | n_fft, got hop={hop}, n_fft={n_fft}")
    k = n_fft // hop
    n_blocks = nf + k - 1
    out_len = (nf - 1) * hop + n_fft
    acc_dtype = torch.promote_types(coeffs_t.dtype, torch.float32)
    cpad = F.pad(coeffs_t.to(acc_dtype), (0, 0, k - 1, k - 1))
    mat_acc = mat.to(acc_dtype)
    out = None
    for j in range(k):
        # block b collects frame f = b − j  ⇒  cpad row (k−1) − j + b
        part = cpad[..., (k - 1) - j : (k - 1) - j + n_blocks, :] @ mat_acc[:, j * hop : (j + 1) * hop]
        out = part if out is None else out + part
    out = out.to(torch.promote_types(coeffs_t.dtype, mat.dtype))
    return out.reshape(*lead, -1)[..., :out_len]
