"""Utterance-batch data parallelism.

Counterpart of ``spectrograms_tpu.parallel.data``. JAX shards the batch
axis of one jitted ``vmap`` program over a ``('data',)`` mesh. Here a batch
is split into row blocks, one a coordinate of the mesh axis, each placed
on its entry's device (:class:`ShardedBatch`); the forward runs once a
block, on that block's device, with the plan's constants there
(:func:`plan_replica`). Feature lanes are independent, so nothing moves
between devices and nothing calls ``torch.distributed``: zero collectives
by construction. In a multi-process group each process holds only the
blocks of the mesh entries it owns.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List

import torch

from ..errors import InvalidInputError
from .mesh import Mesh, _world

__all__ = ["shard_batch", "data_parallel_pipeline", "audio_seconds_per_second"]


@dataclass(frozen=True)
class Shard:
    """One row block of a :class:`ShardedBatch`: ``data`` holds rows
    ``index`` of the batch, on ``device``."""

    index: slice
    device: torch.device
    data: object


class ShardedBatch:
    """A (B, …) batch split over a mesh axis: this process's row blocks,
    each on its mesh entry's device (JAX's global array with a
    ``NamedSharding``)."""

    def __init__(self, shards: List[Shard], shape, mesh: Mesh, axis: str):
        self.addressable_shards = shards
        self.shape = tuple(shape)
        self.mesh = mesh
        self.axis = axis

    def gather(self, device=None) -> torch.Tensor:
        """The whole batch on one device (default: the first block's), rows
        in order. Every row must be held by this process."""
        blocks = {}
        for sh in self.addressable_shards:
            blocks.setdefault(sh.index.start, sh)
        rows = sorted(blocks)
        if sum(blocks[r].index.stop - r for r in rows) != self.shape[0]:
            raise InvalidInputError(
                "this process holds only some rows of the batch; read "
                "addressable_shards instead"
            )
        device = blocks[rows[0]].device if device is None else torch.device(device)
        return torch.cat([blocks[r].data.to(device) for r in rows])

    def __array__(self, dtype=None, copy=None):
        arr = self.gather("cpu").detach().numpy()
        return arr.astype(dtype) if dtype is not None else arr


def _block_rows(mesh: Mesh, axis: str, n_rows: int):
    """``(row slice, device)`` of each block this process holds, one for
    each distinct (block, device) pair of the entries it owns."""
    n_dev = mesh.shape[axis]
    per = n_rows // n_dev
    rank = _world()[0]
    seen, out = set(), []
    for k, dev, owner in mesh.entries(axis):
        if owner != rank or (k, dev) in seen:
            continue
        seen.add((k, dev))
        out.append((slice(k * per, (k + 1) * per), dev))
    return sorted(out, key=lambda e: e[0].start)


def shard_batch(batch, mesh: Mesh, axis: str = "data", pad: bool = True,
                return_mask: bool = False):
    """Place a (B, …) array with its leading axis sharded over ``axis``.

    Uneven batches (B not a multiple of the mesh axis) are zero-padded up to
    the next multiple by default; pass ``return_mask=True`` to also get the
    (B_padded,) bool row-validity mask (a CPU tensor) for downstream
    masking, or ``pad=False`` to make uneven batches an error. Each block
    is a copy on its entry's device.
    """
    x = torch.as_tensor(batch)
    n_dev = mesh.shape[axis]
    b = x.shape[0]
    rem = b % n_dev
    if rem != 0:
        if not pad:
            raise InvalidInputError(
                f"batch size {b} must divide evenly over mesh axis "
                f"'{axis}' of size {n_dev} (or pass pad=True)"
            )
        extra = n_dev - rem
        if not return_mask:
            warnings.warn(
                f"shard_batch zero-padded the batch from {b} to {b + extra} "
                f"rows to divide over the '{axis}' mesh axis. Features "
                "computed on the all-zero padding rows (e.g. dB-floor "
                "values) flow downstream as if they were real rows and WILL "
                "corrupt any statistic taken over the batch axis. Pass "
                "return_mask=True and mask them, or pad=False to make "
                "uneven batches an error (the pre-0.2 behaviour).",
                stacklevel=2,
            )
        x = torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])
    shards = [Shard(rows, dev, x[rows].to(dev, copy=True))
              for rows, dev in _block_rows(mesh, axis, x.shape[0])]
    out = ShardedBatch(shards, x.shape, mesh, axis)
    if return_mask:
        mask = torch.zeros(x.shape[0], dtype=torch.bool)
        mask[:b] = True
        return out, mask
    return out


def plan_replica(plan, device):
    """``plan`` with its constants on ``device``: the plan itself when it
    is there already, else a copy built from its configuration, cached on
    the plan. A ``FeatureSet`` is copied member by member (callable members
    are shared: they compute where their input lies)."""
    from ..featureset import FeatureSet, _is_plan

    device = torch.device(device)
    own = getattr(plan, "device", None)
    if own is None or own == device:
        return plan
    cache = plan.__dict__.setdefault("_device_replicas", {})
    replica = cache.get(device)
    if replica is None:
        if isinstance(plan, FeatureSet):
            replica = FeatureSet([plan_replica(m, device) if _is_plan(m) else m
                                  for m in plan._members])
        else:
            from ..autotune import _rebuild_with_method

            replica = _rebuild_with_method(plan, plan._method_arg, device)
        cache[device] = replica
    return replica


def _forward_on(forward_one, device):
    """``forward_one``, or the same method of the plan's copy on
    ``device`` when it is a bound method of a plan on another device."""
    owner = getattr(forward_one, "__self__", None)
    if owner is None or getattr(owner, "device", None) in (None, torch.device(device)):
        return forward_one
    return getattr(plan_replica(owner, device), forward_one.__name__)


def data_parallel_pipeline(forward_one, mesh: Mesh, axis: str = "data"):
    """Wrap a forward function into a mesh-sharded batch program.

    ``forward_one(x) -> features`` takes leading batch axes (the port's
    ``_forward_impl`` and ``_forward`` do), and runs once a row block on
    the block's device; a bound method of a plan on another device runs
    on the plan's copy there. The program takes a :class:`ShardedBatch`
    (or an array, sharded first with ``pad=False``) and returns one whose
    blocks stay where they were computed.
    """

    def run(batch):
        sb = batch if isinstance(batch, ShardedBatch) else shard_batch(batch, mesh, axis,
                                                                       pad=False)
        shards = [Shard(sh.index, sh.device, _forward_on(forward_one, sh.device)(sh.data))
                  for sh in sb.addressable_shards]
        tail = tuple(shards[0].data.shape[1:]) if shards else ()
        return ShardedBatch(shards, (sb.shape[0],) + tail, mesh, axis)

    return run


def audio_seconds_per_second(
    batch_size: int,
    clip_seconds: float,
    wall_seconds: float,
    mesh: Mesh = None,
) -> float:
    """Throughput metric: audio-seconds processed per wall-clock second,
    per mesh entry when ``mesh`` is given (divides by the mesh's size)."""
    total = batch_size * clip_seconds / wall_seconds
    if mesh is not None:
        total /= mesh.devices.size
    return total
