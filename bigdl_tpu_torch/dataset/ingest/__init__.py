"""bigdl_tpu_torch.dataset.ingest: the staged, threaded ingest engine
(counterpart of ``bigdl_tpu/dataset/ingest``).

Turns the serial shard-read -> decode -> collate -> copy-to-the-card chain
into overlapping stages behind bounded queues, while keeping epoch order
bit-exact (sequence-numbered reorder buffers + replayable RNG draws).
Entry points:

- :class:`PrefetchingDataSet`: ``AbstractDataSet`` drop-in over a shard
  folder (``from_folder``) or explicit path list.
- :class:`IngestEngine` / :class:`IngestConfig`: the raw staged engine for
  one epoch's ordered task list.
"""

from bigdl_tpu_torch.dataset.ingest.dataset import PrefetchingDataSet
from bigdl_tpu_torch.dataset.ingest.engine import (IngestConfig,
                                                   IngestEngine,
                                                   validate_chain)
from bigdl_tpu_torch.dataset.ingest.reorder import ReorderBuffer

__all__ = ["PrefetchingDataSet", "IngestConfig", "IngestEngine",
           "ReorderBuffer", "validate_chain"]
