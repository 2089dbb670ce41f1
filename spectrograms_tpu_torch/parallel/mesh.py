"""Device meshes, named shardings and multi-process bring-up.

Counterpart of ``spectrograms_tpu.parallel.mesh``. JAX's ``Mesh`` holds
JAX devices of every process; ``torch.distributed.DeviceMesh`` needs one
process a device and cannot express one process driving several cards,
which is JAX's model. So the port has a small :class:`Mesh` of its own: a
numpy array of ``torch.device`` entries with axis names, ``.shape`` as a
name → size mapping and ``.devices.size``, and for each entry the rank of
the process that owns it.

A mesh may repeat a device (JAX's may not): the CPU builds JAX's 8-entry
meshes on the host, and one card runs a 4-entry mesh on ``cuda:0`` that
exercises the shard and halo code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import InvalidInputError

__all__ = ["create_device_mesh", "make_named_sharding", "initialize_distributed"]


def _world() -> Tuple[int, int]:
    """(this process's rank, number of processes): (0, 1) unless a
    ``torch.distributed`` process group is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_devices() -> list:
    """The devices this process drives: every visible card, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` → ``cuda:<current>``, as plans resolve it."""
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A logical mesh of ``torch.device`` entries with named axes.

    ``process_ids`` gives the rank that owns each entry (all 0 in one
    process). Two meshes are equal when their entries, owners and axis
    names are.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_ids: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_ids = (np.zeros(devices.shape, dtype=np.int64) if process_ids is None
                            else np.asarray(process_ids, dtype=np.int64))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape,
                self.axis_names, tuple(self.process_ids.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"

    def entries(self, axis: str):
        """``(coordinate along axis, device, owner rank)`` of every entry."""
        k = self.axis_names.index(axis)
        for idx in np.ndindex(self.devices.shape):
            yield idx[k], self.devices[idx], int(self.process_ids[idx])

    def axis_devices(self, axis: str) -> list:
        """One ``(device, owner rank)`` for each coordinate along ``axis``
        (the entry at coordinate 0 of every other axis)."""
        k = self.axis_names.index(axis)
        out = []
        for i in range(self.devices.shape[k]):
            idx = tuple(i if j == k else 0 for j in range(self.devices.ndim))
            out.append((self.devices[idx], int(self.process_ids[idx])))
        return out

    def is_local(self) -> bool:
        """True when this process owns every entry."""
        return bool((self.process_ids == _world()[0]).all())


def create_device_mesh(
    mesh_shape: Tuple[int, ...],
    axis_names: Sequence[str] = ("data",),
    devices=None,
) -> Mesh:
    """Build a logical device mesh with named axes.

    The feature pipeline wants a 1-D ``('data',)`` mesh (independent
    utterance lanes) or a 2-D ``('data', 'time')`` mesh when long signals
    are also sharded over the frame axis. ``devices`` is the global list of
    entries (``torch.device`` or strings; repeats allowed); by default every
    process's cards (the CPU where there is none), assuming each process of
    a ``torch.distributed`` group drives as many. Entries belong to the
    processes in contiguous equal blocks, in rank order.
    """
    world = _world()[1]
    if devices is None:
        devices = local_devices() * world
    devices = [_indexed(torch.device(d)) for d in devices]
    n_needed = int(np.prod(mesh_shape))
    if n_needed > len(devices):
        raise InvalidInputError(
            f"mesh shape {mesh_shape} needs {n_needed} devices, have {len(devices)}"
        )
    if len(mesh_shape) != len(axis_names):
        raise InvalidInputError("mesh_shape and axis_names must have the same length")
    owners = np.arange(len(devices), dtype=np.int64) * world // len(devices)
    dev_array = np.empty(n_needed, dtype=object)
    for i in range(n_needed):
        dev_array[i] = devices[i]
    return Mesh(dev_array.reshape(mesh_shape), tuple(axis_names),
                owners[:n_needed].reshape(mesh_shape))


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec (one mesh axis name, or None, a
    dimension): ``shard_batch`` splits the leading dimension over
    ``spec[0]``."""

    mesh: Mesh
    spec: tuple


def make_named_sharding(mesh: Mesh, spec) -> NamedSharding:
    """NamedSharding helper."""
    return NamedSharding(mesh, tuple(spec))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group`` at
    ``tcp://<coordinator_address>`` (``host:port``), on ``nccl`` when the
    process has a card and ``gloo`` otherwise.

    A no-op for one process. Call before building a mesh.
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise InvalidInputError(
            "initialize_distributed needs coordinator_address and process_id "
            "for more than one process"
        )
    import torch.distributed as dist

    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
