"""Standalone constant-Q transform (complex CQT matrix), in PyTorch.

Counterpart of ``spectrograms_tpu.cqt``, with the reference's contract
(``cqt`` / ``CqtResult``, ``cqt.rs:640-709``): kernels generated at
``min(len(signal), 16384)`` samples, frames by ``hop``, each kernel
correlated (conjugated) against the end of each frame. The integrated
spectrogram path (``FreqScale.CQT`` plans) lives in ``pipeline.py``.

All frames go through the packed real ``[re | −im]`` kernel matrix in one
framed matmul, and the complex data is assembled from its two halves. When
the truncation policy elects the octave-stacked path
(``ops.cqt.resolve_cqt_policy``), each group of bins correlates against a
2^d-decimated copy of the signal (:func:`multirate_ri_blocks`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .dtypes import (check_precision, check_true_f32, complex_dtype, parse_dtype,
                     real_dtype_name, resolve_device)
from .errors import InvalidInputError
from .ops.cqt import cqt_kernel_matrices, multirate_cqt_groups, resolve_cqt_policy
from .ops.decimate import decimate_pow2_framed
from .ops.framing import frame_count, framed_matmul
from .params import CqtParams
from .spans import span

__all__ = ["CqtResult", "cqt"]

_MAX_KERNEL_FRAME = 16384


def multirate_ri_blocks(x, groups_dev, hop: int, nf: int, precision=None,
                        composite: bool = False, level_provider=None):
    """Per-group [re | −im] correlations of the octave-stacked CQT.

    ``groups_dev``: ``(d, k_ri, e0, flen, jp)`` per group, as
    :func:`spectrograms_tpu_torch.ops.cqt.multirate_cqt_groups` builds them,
    with ``k_ri`` a tensor on the signal's device. For each group the signal
    is 2^d-decimated (zero-phase half-band, time-aligned grid) and framed so
    that frame ``i`` ends on the same instant as full-rate frame ``i``
    (decimated index ``i·hop/2^d + e0``): the pre-scaled kernels then give
    the *untruncated* full-rate correlation. ``flen`` may be shorter than the
    plan's frame (``depth="max"``); frames then cover the last ``flen``
    decimated samples before each frame end, where the right-aligned kernels
    live.

    ``jp > 1`` marks a frame-packed group: ``k_ri`` is the block-banded
    (flen + jp·hop_d, jp·2nb) super-kernel whose column block m holds the
    kernels shifted to rows [m·hop_d, m·hop_d+flen). One framed matmul at
    super-hop jp·hop_d computes jp consecutive frames a row, unpacked by a
    reshape.

    ``composite=True`` (the ``depth="max"`` path) lets the cascade skip
    levels no group reads, by stride-4 composite stages; ``composite=False``
    builds every level by single half-band stages. ``level_provider``
    (``d -> level-d signal`` of ``ceil(n/2^d)`` samples) replaces the
    internal lazy cascade: :class:`~spectrograms_tpu_torch.FeatureSet`
    hands in its shared ``DecimationCascade`` through it. ``precision`` keys
    nothing here; the products are true f32 on the card.

    ``x`` is (..., n); returns one (..., nf, 2·nb) tensor a group, in group
    (= ascending bin) order.
    """
    with span("tg.op.cqt.multirate_ri_blocks"):
        if level_provider is None:
            levels = {0: x}

            def level_provider(d, _levels=levels):
                if d not in _levels:
                    if composite and d - 1 not in _levels and d >= 2:
                        _levels[d] = decimate_pow2_framed(level_provider(d - 2), 2, precision)
                    else:
                        _levels[d] = decimate_pow2_framed(level_provider(d - 1), 1, precision)
                return _levels[d]

        outs = []
        for d, k_ri, e0, flen, jp in groups_dev:
            y = level_provider(d)
            hop_d = hop >> d
            nf_sup = -(-nf // jp)  # super-frames that cover nf frames
            n_fft_sup = int(k_ri.shape[0])  # flen when jp == 1
            hop_sup = jp * hop_d
            need = (nf_sup - 1) * hop_sup + n_fft_sup
            left = flen - e0  # shift so that frame i ends at decimated i·hop_d + e0
            if left < 0:
                y = y[..., -left:]
                left = 0
            total = left + y.shape[-1]
            w = F.pad(y, (left, max(0, need - total)))[..., :need]
            ri = framed_matmul(w, k_ri, n_fft_sup, hop_sup, centre=False)  # (..., nf_sup, jp·2nb)
            if jp > 1:
                nb2 = k_ri.shape[1] // jp
                ri = ri.reshape(*ri.shape[:-2], nf_sup * jp, nb2)
            outs.append(ri[..., :nf, :])
        return outs


@dataclass
class CqtResult:
    """Complex CQT coefficients (n_bins, n_frames) and their axes. ``data``
    is a complex64/complex128 tensor on the device it was computed on."""

    data: torch.Tensor
    frequencies: np.ndarray
    sample_rate: float
    hop_size: int

    @property
    def n_bins(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> str:
        """Real-precision dtype name (reference result-class getter)."""
        return real_dtype_name(self.data.dtype)

    @property
    def n_frames(self) -> int:
        return self.data.shape[1]

    def to_magnitude(self) -> torch.Tensor:
        return self.data.abs()

    def to_power(self) -> torch.Tensor:
        return self.data.real ** 2 + self.data.imag ** 2

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()


def cqt(samples, sample_rate: float, params: CqtParams, hop_size: int, dtype=None,
        precision=None, device=None) -> CqtResult:
    """Complex CQT of a signal → :class:`CqtResult` with (n_bins, n_frames) data.

    ``precision`` keeps the JAX package's argument; the products are true
    f32 (or f64) whatever it says. Computes on CUDA unless ``device="cpu"``.
    """
    dt = parse_dtype(dtype if dtype is not None else getattr(samples, "dtype", None))
    dev = resolve_device(device)
    check_precision(precision)
    x = torch.as_tensor(samples).to(device=dev, dtype=dt).reshape(-1)
    if x.shape[0] == 0:
        raise InvalidInputError("signal must be non-empty")
    if hop_size <= 0:
        raise InvalidInputError("hop_size must be > 0")
    if x.is_cuda and dt == torch.float32:
        check_true_f32()

    frame_len = min(x.shape[0], _MAX_KERNEL_FRAME)
    # The truncation policy: the full-Q octave stack when truncation would
    # cost > 1 % of Q and the hop admits decimation; truncate=True keeps the
    # reference-parity dense clamp.
    params = resolve_cqt_policy(params, float(sample_rate), int(frame_len), int(hop_size), False)

    if params.multirate:
        groups, freqs = multirate_cqt_groups(
            params, float(sample_rate), int(frame_len), int(hop_size), False,
            depth=params.multirate_depth,
        )
        groups_dev = [(d, torch.tensor(k_ri, dtype=dt, device=dev), e0, flen, jp)
                      for d, k_ri, e0, flen, jp in groups]
        nf = frame_count(int(x.shape[0]), int(frame_len), int(hop_size), False)
        blocks = multirate_ri_blocks(x, groups_dev, int(hop_size), nf, precision,
                                     composite=params.multirate_depth == "max")
        parts = []
        for ri in blocks:
            nb = ri.shape[-1] // 2
            parts.append(torch.complex(ri[:, :nb], ri[:, nb:]).T)
        data = torch.cat(parts, dim=0).to(complex_dtype(dt))
        return CqtResult(data=data, frequencies=freqs, sample_rate=float(sample_rate),
                         hop_size=int(hop_size))

    k_re, k_im, freqs = cqt_kernel_matrices(params, sample_rate, frame_len)
    k_ri = torch.tensor(np.concatenate([k_re.T, k_im.T], axis=1), dtype=dt, device=dev)
    # centre=False framing is the CQT's: one frame when the signal is shorter
    # than the frame, else (len − frame_len)//hop + 1
    re, im = framed_matmul(x, k_ri, frame_len, int(hop_size), centre=False).chunk(2, dim=-1)
    data = torch.complex(re, im).T.to(complex_dtype(dt))
    return CqtResult(data=data, frequencies=freqs, sample_rate=float(sample_rate),
                     hop_size=int(hop_size))
