"""Sequence (time-axis) parallelism for long signals.

Counterpart of ``spectrograms_tpu.parallel.sequence``, with its layout
exactly. STFT frames are independent after centre padding, so a long signal
shards over the frame axis with one exchange: each mesh entry needs the
first ``n_fft − hop`` samples of its right neighbour's chunk (the halo).

Layout: the padded signal is split into P contiguous chunks of
``frames_per_device × hop`` samples. Entry d computes frames
``[d·F, (d+1)·F)`` from ``[its chunk | halo from d+1]``; the last entry's
halo is zeros, which is exactly the global zero padding. In one process
the halo is a copy from entry d+1's device to entry d's (P − 1 of them,
counted in ``sequence_parallel_spectrogram.halo_copies``), and the frame
blocks come together on the plan's device in one gather (counted in
``.gathers``). The mesh entries along the axis must belong to this
process.

A shard's ``[chunk | halo]`` holds exactly its F frames without centre
padding, so for a mel / log-Hz / ERB / linear plan it runs through a copy
of the plan with ``centre=False`` on the entry's device: its forward, the
fused kernel on a CUDA float32 plan. CQT and multirate plans frame the
shard and run the plan's full-rate frames step, as the JAX package does.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from ..errors import InvalidInputError
from ..ops.framing import frame_count
from ..params import SpectrogramParams, StftParams
from ..pipeline import FreqScale, SpectrogramPlan
from .data import plan_replica
from .mesh import Mesh, _world

__all__ = ["sequence_parallel_spectrogram"]


def _centreless(plan: SpectrogramPlan, device: torch.device) -> SpectrogramPlan:
    """The plan with ``centre=False`` on ``device``, cached on the plan."""
    st = plan.params.stft
    if not st.centre:
        return plan_replica(plan, device)
    cache = plan.__dict__.setdefault("_centreless_copies", {})
    if device not in cache:
        cache[device] = SpectrogramPlan(
            SpectrogramParams(StftParams(st.n_fft, st.hop_size, st.window, centre=False),
                              plan.params.sample_rate_hz),
            plan.freq_scale,
            plan.amp_scale,
            scale_params=plan.scale_params,
            log_params=plan.log_params,
            dtype=plan._dtype,
            method=plan._method_arg,
            precision=plan.precision,
            device=device,
        )
    return cache[device]


def _shard_step(plan: SpectrogramPlan, device: torch.device, n_fft: int, hop: int,
                frames_per_dev: int):
    """``[chunk | halo]`` on ``device`` → its (n_out, F) features."""
    if (plan.freq_scale != FreqScale.CQT and plan._multirate_inner is None):
        return _centreless(plan, device)._forward
    local = plan_replica(plan, device)

    def frames_step(ext):
        frames = ext.unfold(-1, n_fft, hop)[:frames_per_dev]
        return local._forward_frames(frames).transpose(-1, -2)

    return frames_step


def sequence_parallel_spectrogram(plan: SpectrogramPlan, mesh: Mesh, axis: str = "time"):
    """Build a time-sharded spectrogram function from a plan.

    Returns ``fn(x) -> (n_bins, n_frames)``, a tensor on the plan's device,
    whose frame axis is computed shard by shard over ``mesh[axis]`` with one
    halo exchange between neighbours.
    """
    n_fft, hop, centre = plan._n_fft, plan._hop, plan._centre
    n_dev = mesh.shape[axis]
    halo_len = n_fft - hop if n_fft > hop else 0
    rank = _world()[0]
    devices = []
    for dev, owner in mesh.axis_devices(axis):
        if owner != rank:
            raise InvalidInputError(
                "sequence_parallel_spectrogram runs within one process: every "
                f"entry of the mesh's '{axis}' axis must belong to this process"
            )
        devices.append(dev)

    if plan._multirate_inner is not None or plan._cqt_multirate is not None:
        # The shard step consumes full-rate frames (the halo is sized for
        # them), so the multirate route cannot engage here.
        warnings.warn(
            "sequence_parallel_spectrogram computes multirate plans at the "
            "full rate (mel/log-Hz: ~1e-5 relative vs compute(); CQT: "
            "truncated-kernel low bins). Use data parallelism "
            "(parallel.data) to keep the multirate path.",
            stacklevel=2,
        )

    def run(x):
        x = torch.as_tensor(x).to(plan._dtype)
        if x.ndim != 1 or x.shape[0] == 0:
            raise InvalidInputError("expected a non-empty 1-D signal")
        x_len = int(x.shape[0])
        n_frames = frame_count(x_len, n_fft, hop, centre)
        pad_left = n_fft // 2 if centre else 0
        # Chunks (frames_per_dev·hop each) cover the whole padded signal:
        # the signal's tail reaches frames only through the halo of the
        # entry that owns those samples, so nothing may fall past the last
        # chunk.
        frames_per_dev = max(
            -(-n_frames // n_dev),                     # every frame owned
            -(-(pad_left + x_len) // (hop * n_dev)),   # every sample owned
        )
        total_frames = frames_per_dev * n_dev
        pad_right = total_frames * hop - pad_left - x_len
        xp = F.pad(x, (pad_left, pad_right))
        chunk = frames_per_dev * hop
        chunks = [xp[d * chunk:(d + 1) * chunk].to(dev) for d, dev in enumerate(devices)]
        outs = []
        for d, dev in enumerate(devices):
            if d + 1 < n_dev:
                halo = chunks[d + 1][:halo_len].to(dev, copy=True)
                sequence_parallel_spectrogram.halo_copies += 1
            else:
                halo = torch.zeros(halo_len, dtype=x.dtype, device=dev)
            ext = torch.cat([chunks[d], halo])
            outs.append(_shard_step(plan, dev, n_fft, hop, frames_per_dev)(ext))
        out = torch.cat([o.to(plan.device) for o in outs], dim=-1)
        sequence_parallel_spectrogram.gathers += 1
        return out[..., :n_frames]

    return run


sequence_parallel_spectrogram.halo_copies = 0
sequence_parallel_spectrogram.gathers = 0
