"""``PrefetchingDataSet`` (counterpart of
``bigdl_tpu/dataset/ingest/dataset.py``): the ingest engine behind the
standard ``AbstractDataSet`` protocol.

Drop-in for ``ShardFolder.stream(folder) >> decoder``: the optimizer,
the evaluator and ``apps/ingest_bench.py`` consume it through the same
``data()/size()/shuffle()`` surface, but ``data(train=True)`` runs the
staged threaded engine (``dataset/ingest/engine.py``) instead of the
serial chain; with the engine's default config its batches arrive on the
card.

Ordering contract (what makes resume and replay bit-exact):

- ``shuffle()`` draws the per-epoch shard-order permutation AND one
  epoch record-shuffle seed from the process RNG — the SAME replayable
  call sequence the resilience resume path re-executes
  (``for _ in range(epoch-1): dataset.shuffle()``).
- ``data()`` consumes NO host RNG: per-shard shuffles derive from
  ``(epoch_seed, shard_seq)`` alone, so serial and pipelined execution,
  and an interrupted vs uninterrupted run, all see bit-identical record
  order. (``StreamingShardDataSet`` draws inside iteration instead,
  which a worker pool cannot reproduce — thread-local RNGs would make
  the draw order schedule-dependent.)

A shard folder stays local, as ``ShardFolder.stream``'s does in the port:
one process, one card (``is_distributed`` is false; the distributed plane
waits for ROADMAP A.4). ``from_folder`` takes this process's round-robin
slice, all of the folder without a process group.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence

from bigdl_tpu_torch.dataset.base import AbstractDataSet, Transformer
from bigdl_tpu_torch.dataset.ingest.engine import (IngestConfig, IngestEngine,
                                                   validate_chain)
from bigdl_tpu_torch.utils.rng import RandomGenerator

__all__ = ["PrefetchingDataSet"]


def _shard_seed(epoch_seed: int, seq: int) -> List[int]:
    """Per-shard shuffle seed: a pure function of (epoch seed, shard
    sequence number) — any worker, in any completion order, derives the
    same record permutation (fed to ``np.random.default_rng`` as
    SeedSequence entropy)."""
    return [int(epoch_seed), int(seq)]


class PrefetchingDataSet(AbstractDataSet):
    """Pipelined shard ingest fronting the ``AbstractDataSet`` protocol.

    ``transformer`` is the decode/collate chain the engine's decode pool
    clones per worker (validated: deterministic per-record stages plus at
    most one trailing batcher). ``config.workers == 0`` selects the
    serial engine: identical ordering rule, no threads — the A/B
    baseline ``apps/ingest_bench.py --engine serial`` measures.
    """

    def __init__(self, paths: Sequence[str],
                 transformer: Optional[Transformer] = None,
                 config: Optional[IngestConfig] = None,
                 serial: bool = False):
        validate_chain(transformer)  # fail at construction, not in a pool
        self._paths = list(paths)
        self._transformer = transformer
        self.config = config or IngestConfig()
        self.serial = bool(serial)
        self._order = list(range(len(self._paths)))
        self._epoch_seed: Optional[int] = None
        self._shuffled = False
        self._size: Optional[int] = None
        # engines spawned by live epoch iterators, so drain() can stop
        # them from the preemption path (worker threads never touch this;
        # the lock serializes consumer-thread vs signal-path access)
        self._live_lock = threading.Lock()
        self._live: List[IngestEngine] = []

    @classmethod
    def from_folder(cls, folder: str,
                    transformer: Optional[Transformer] = None,
                    config: Optional[IngestConfig] = None,
                    host_index: Optional[int] = None,
                    host_count: Optional[int] = None,
                    serial: bool = False) -> "PrefetchingDataSet":
        """Engine over this host's round-robin shard slice (the
        multi-process mesh layout of ``ShardFolder.paths``)."""
        from bigdl_tpu_torch.dataset.shards import ShardFolder
        return cls(ShardFolder.paths(folder, host_index, host_count),
                   transformer, config, serial=serial)

    # ------------------------------------------------------------- protocol
    def _tasks(self, train: bool):
        order = self._order if train else range(len(self._paths))
        shuffle = train and self._shuffled
        return [(self._paths[i],
                 _shard_seed(self._epoch_seed, seq) if shuffle else None)
                for seq, i in enumerate(order)]

    def data(self, train: bool) -> Iterator:
        tasks = self._tasks(train)
        if self.serial or self.config.workers == 0:
            return self._serial_iter(tasks)
        return self._engine_iter(tasks)

    def _serial_iter(self, tasks) -> Iterator:
        """Same ordering rule as the pipeline, executed inline."""
        import numpy as np
        from bigdl_tpu_torch.dataset.shards import read_shard

        def records():
            for path, seed in tasks:
                recs = list(read_shard(path))
                if seed is not None:
                    np.random.default_rng(seed).shuffle(recs)
                yield from recs

        if self._transformer is None:
            return records()
        return self._transformer(records())

    def _engine_iter(self, tasks) -> Iterator:
        from bigdl_tpu_torch.dataset.shards import read_shard
        engine = IngestEngine(tasks, read_shard, self._transformer,
                              self.config)
        with self._live_lock:
            self._live.append(engine)
        try:
            for item in engine:
                if self._transformer is None and isinstance(item, list):
                    # unbatched chunks flatten to records; re-check the
                    # engine between records so drain() cuts the stream
                    # even when a chunk is already in this generator
                    for rec in item:
                        if engine.closed:
                            return
                        yield rec
                else:
                    if engine.closed:
                        return
                    yield item
        finally:
            engine.close()
            with self._live_lock:
                if engine in self._live:
                    self._live.remove(engine)

    def size(self) -> int:
        if self._size is None:
            from bigdl_tpu_torch.dataset.shards import _count_records
            self._size = sum(_count_records(p) for p in self._paths)
        return self._size

    def shuffle(self) -> None:
        rng = RandomGenerator.RNG()
        rng.shuffle(self._order)
        # ONE draw per epoch; data() derives every per-shard shuffle from
        # it, so iteration itself is RNG-pure (resume replays shuffle()
        # calls only — see module docstring)
        self._epoch_seed = int(rng.uniform(0.0, float(2 ** 31 - 1)))
        self._shuffled = True

    def is_distributed(self) -> bool:
        # one process on one card, as the port's StreamingShardDataSet
        return False

    # ---------------------------------------------------------------- drain
    def drain(self) -> None:
        """Stop and join every live epoch engine — the preemption path
        (``PreemptionHandler`` drain hooks) calls this before the final
        snapshot so no reader/decoder thread races shard files or device
        transfers against checkpoint IO."""
        with self._live_lock:
            live = list(self._live)
            self._live.clear()
        for engine in live:
            engine.close()
