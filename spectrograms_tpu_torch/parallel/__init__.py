"""Several devices and processes: meshes, sharded batches, halo exchange.

Counterpart of ``spectrograms_tpu.parallel``:

- :mod:`~spectrograms_tpu_torch.parallel.mesh` — device meshes (the port's
  own ``Mesh`` of ``torch.device`` entries) and ``initialize_distributed``
  (``torch.distributed`` over TCP)
- :mod:`~spectrograms_tpu_torch.parallel.data` — utterance-batch data
  parallelism over a ``('data',)`` mesh axis: a row block per entry, the
  plan's constants on each device, zero collectives
- :mod:`~spectrograms_tpu_torch.parallel.sequence` — long-signal sequence
  parallelism: the time axis sharded, an (n_fft − hop)-sample halo from
  each right neighbour
- :mod:`~spectrograms_tpu_torch.parallel.batching` — ragged-batch utilities
"""

from .mesh import create_device_mesh, make_named_sharding, initialize_distributed
from .data import shard_batch, data_parallel_pipeline, audio_seconds_per_second
from .sequence import sequence_parallel_spectrogram
from .batching import batch, batch_with_metadata, pad_signals

__all__ = [
    "create_device_mesh",
    "make_named_sharding",
    "initialize_distributed",
    "shard_batch",
    "data_parallel_pipeline",
    "audio_seconds_per_second",
    "sequence_parallel_spectrogram",
    "batch",
    "batch_with_metadata",
    "pad_signals",
]
