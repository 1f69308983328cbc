"""Core data-pipeline types (counterpart of ``bigdl_tpu/dataset/base.py``:
``Sample``, ``MiniBatch``, ``ByteRecord``, ``Transformer`` with ``>>``,
``Identity``, ``SampleToBatch`` with its padding, ``BucketBatch``,
``Prefetch``, ``MTTransformer``, ``LocalDataSet``, ``TransformedDataSet``,
``DistributedDataSet`` and ``DataSet.array`` are ported).

Stages are iterator-to-iterator transformers over host numpy, composed with
``>>`` (Scala's ``->``); ``Optimizer`` moves each ``MiniBatch`` to the
device. ``LocalDataSet.shuffle`` draws from its own
``numpy.random.Generator``, seeded by ``DataSet.array(..., seed=...)``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


class Sample:
    """One (feature, label) record (reference ``Sample``)."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label):
        self.feature = np.asarray(feature)
        self.label = np.asarray(label)

    def __repr__(self):
        return f"Sample(feature={self.feature.shape}, label={self.label.shape})"


class MiniBatch:
    """One batch pair (reference ``MiniBatch``)."""

    __slots__ = ("data", "labels")

    def __init__(self, data, labels):
        self.data = data
        self.labels = labels

    def size(self) -> int:
        return int(self.data.shape[0])

    def __iter__(self):
        yield self.data
        yield self.labels


class ByteRecord:
    """Raw bytes and a label (reference ``ByteRecord``)."""

    __slots__ = ("data", "label")

    def __init__(self, data: bytes, label: float):
        self.data = data
        self.label = label


class Transformer:
    """Iterator-to-iterator stage (reference ``Transformer``).
    ``stochastic``: the stage draws random numbers (a random crop, flip or
    jitter), so ``DeviceCachedDataSet`` refuses to cache below it.
    ``aggregating``: an output depends on more than one input record
    (batching), so ``MTTransformer`` cannot run the stage per record."""

    stochastic = False
    aggregating = False

    def __call__(self, prev: Iterator) -> Iterator:
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    def clone_transformer(self) -> "Transformer":
        import copy
        return copy.deepcopy(self)


class ChainedTransformer(Transformer):
    """Two stages in a row (the reference's ``->`` combinator)."""

    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def __call__(self, prev: Iterator) -> Iterator:
        return self.second(self.first(prev))


def _flatten_chain(t: Transformer) -> List[Transformer]:
    if isinstance(t, ChainedTransformer):
        return _flatten_chain(t.first) + _flatten_chain(t.second)
    return [t]


class Identity(Transformer):
    """Passes records through (reference ``Identity``)."""

    def __call__(self, prev: Iterator) -> Iterator:
        return prev


class SampleToBatch(Transformer):
    """Stack Samples into MiniBatches of ``batch_size`` (reference
    ``SampleToBatch``, with its argument order). With ``drop_remainder``
    a short last batch is dropped, else emitted.

    Variable-length samples: with ``feature_padding`` or ``fixed_length``
    every feature is cut or padded along its first axis to
    ``fixed_length`` (else to the batch's longest) with
    ``feature_padding`` (0 when None); labels are padded the same way
    with ``label_padding`` when it is given."""

    aggregating = True

    def __init__(self, batch_size: int, feature_padding=None,
                 label_padding=None, fixed_length=None,
                 drop_remainder: bool = True):
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.fixed_length = fixed_length
        self.drop_remainder = drop_remainder

    @staticmethod
    def _pad_to(arr: np.ndarray, length: int, value: float) -> np.ndarray:
        if arr.shape[0] >= length:
            return arr[:length]
        pad = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad, constant_values=value)

    def __call__(self, prev: Iterator[Sample]) -> Iterator[MiniBatch]:
        buf: List[Sample] = []
        for s in prev:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self._collate(buf)

    def _collate(self, samples: List[Sample],
                 fixed_length: Optional[int] = None) -> MiniBatch:
        if fixed_length is None:
            fixed_length = self.fixed_length
        if self.feature_padding is not None or fixed_length is not None:
            length = fixed_length or max(s.feature.shape[0] for s in samples)
            feats = np.stack([self._pad_to(s.feature, length,
                                           self.feature_padding or 0.0)
                              for s in samples])
            labs = np.stack([self._pad_to(np.atleast_1d(s.label), length,
                                          self.label_padding)
                             if self.label_padding is not None
                             else np.atleast_1d(s.label)
                             for s in samples])
        else:
            feats = np.stack([s.feature for s in samples])
            labs = np.stack([s.label for s in samples])
        if labs.ndim == 2 and labs.shape[1] == 1:
            labs = labs[:, 0]
        return MiniBatch(feats, labs)


class BucketBatch(SampleToBatch):
    """Length-bucketed batches (reference ``BucketBatch``): each sample
    goes to the smallest boundary at least its length, and each batch is
    padded to its bucket's boundary, so a model sees at most
    ``len(boundaries)`` shapes."""

    def __init__(self, batch_size: int, boundaries: Sequence[int],
                 feature_padding: float = 0.0,
                 label_padding: Optional[float] = None,
                 drop_remainder: bool = True):
        super().__init__(batch_size, feature_padding=feature_padding,
                         label_padding=label_padding,
                         drop_remainder=drop_remainder)
        self.boundaries = sorted(int(b) for b in boundaries)
        if not self.boundaries:
            raise ValueError("BucketBatch needs at least one boundary")

    def _bucket_of(self, length: int) -> int:
        for b in self.boundaries:
            if length <= b:
                return b
        raise ValueError(
            f"sample length {length} exceeds the largest bucket boundary "
            f"{self.boundaries[-1]}")

    def __call__(self, prev: Iterator[Sample]) -> Iterator[MiniBatch]:
        buffers: dict = {b: [] for b in self.boundaries}
        for s in prev:
            if s.feature.ndim == 0:
                raise ValueError("BucketBatch needs samples with a leading "
                                 "(length) dimension; got a scalar feature")
            b = self._bucket_of(int(s.feature.shape[0]))
            buffers[b].append(s)
            if len(buffers[b]) == self.batch_size:
                yield self._collate(buffers[b], fixed_length=b)
                buffers[b] = []
        if not self.drop_remainder:
            for b, buf in buffers.items():
                if buf:
                    yield self._collate(buf, fixed_length=b)


class Prefetch(Transformer):
    """Stage up to ``depth`` upstream items in a background thread, so the
    host's decode, augmentation and collation overlap the card's step
    (reference ``Prefetch``); placed last, after batching:
    ``... >> BGRImgToBatch(256) >> Prefetch(2)``. Items keep their order;
    an upstream exception is raised in the consumer.

    It must not sit below a ``DeviceCachedDataSet``, which materialises
    its input once."""

    aggregating = True   # reorders time, not records

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError("Prefetch depth must be >= 1")
        self.depth = depth

    def __call__(self, prev: Iterator) -> Iterator:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        end, err = object(), object()

        def put_or_stop(item) -> bool:
            # every put gives up once the consumer has gone, or the thread
            # could wait forever on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in prev:
                    if not put_or_stop(item):
                        return
                put_or_stop(end)
            except BaseException as e:   # handed to the consumer
                put_or_stop((err, e))

        t = threading.Thread(target=produce, daemon=True,
                             name="bigdl-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] is err:
                    raise item[1]
                yield item
        finally:
            stop.set()   # finished or abandoned: release the producer


class MTTransformer(Transformer):
    """Run a per-record stage on ``workers`` threads, keeping the order
    (reference ``MTTransformer``). Each thread runs its own
    ``clone_transformer()`` of ``inner``, so stateful stages do not race
    (a random stage's draws then differ from a single thread's). Outputs
    of one record (none, one or several) come out in input order; at most
    ``window`` records are in flight. A stage that aggregates records
    (batching) is refused: chain it after, ``mt >> SampleToBatch(...)``."""

    def __init__(self, inner: Transformer, workers: int = 4,
                 window: Optional[int] = None):
        stages = _flatten_chain(inner)
        self.stochastic = any(getattr(s, "stochastic", False) for s in stages)
        for stage in stages:
            if stage.aggregating:
                raise ValueError(
                    f"MTTransformer cannot fan out {type(stage).__name__}: "
                    "it aggregates across records (per-record invocation "
                    "would silently produce wrong/empty output). Put "
                    "MTTransformer around the per-record stages and chain "
                    "the batching stage after it: mt_stage >> SampleToBatch")
        self.inner = inner
        self.workers = max(1, int(workers))
        self.window = window or self.workers * 2

    def __call__(self, prev: Iterator) -> Iterator:
        if self.workers == 1:
            return self.inner(prev)
        return self._parallel(prev)

    def _parallel(self, prev: Iterator) -> Iterator:
        import collections
        import concurrent.futures as cf
        import threading

        local = threading.local()

        def apply_one(item):
            t = getattr(local, "t", None)
            if t is None:
                t = local.t = self.inner.clone_transformer()
            return list(t(iter([item])))

        with cf.ThreadPoolExecutor(self.workers,
                                   thread_name_prefix="bigdl-mt") as ex:
            pending: "collections.deque" = collections.deque()
            for item in prev:
                pending.append(ex.submit(apply_one, item))
                if len(pending) >= self.window:
                    yield from pending.popleft().result()
            while pending:
                yield from pending.popleft().result()


class AbstractDataSet:
    """reference ``AbstractDataSet``."""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def is_distributed(self) -> bool:
        return False

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer) -> "AbstractDataSet":
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """In-memory dataset (reference ``LocalDataSet``): ``data(train=True)``
    iterates one epoch in the current shuffled order."""

    def __init__(self, data: Sequence, seed: Optional[int] = None):
        self._data = list(data)
        self._order = np.arange(len(self._data))
        self._rng = np.random.default_rng(seed)

    def data(self, train: bool) -> Iterator:
        if train:
            for i in self._order:
                yield self._data[i]
        else:
            yield from self._data

    def size(self) -> int:
        return len(self._data)

    def shuffle(self) -> None:
        self._rng.shuffle(self._order)


class TransformedDataSet(AbstractDataSet):
    """A dataset with a transformer chain applied lazily per epoch."""

    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))

    def size(self) -> int:
        return self.base.size()

    def shuffle(self) -> None:
        self.base.shuffle()

    def is_distributed(self) -> bool:
        return self.base.is_distributed()

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        return TransformedDataSet(self.base, self.transformer >> transformer)


class DistributedDataSet(LocalDataSet):
    """A dataset for data-parallel training (reference
    ``DistributedDataSet``): each process of the group keeps its
    round-robin slice ``data[p::n]`` of the records (the reference's
    multi-host path, ``CachedDistriDataSet``'s pinned partitions), so a
    batching stage's size is PER PROCESS. ``shard_by_process=False``
    keeps ``data`` whole: it is already this process's."""

    def __init__(self, data: Sequence, shard_by_process: bool = True,
                 seed: Optional[int] = None):
        self._all = None
        if shard_by_process:
            from bigdl_tpu_torch.utils.engine import Engine
            p, n = Engine.process_index(), Engine.process_count()
            if n > 1:
                self._all = list(data)
                data = self._all[p::n]
        super().__init__(data, seed)

    def shard_by_data_rank(self, index: int, count: int) -> None:
        """Keep ``data[index::count]`` of the records instead of the
        process's slice: under a tensor or sequence axis the ranks that
        share a data coordinate train the same rows
        (``DistriOptimizer`` calls this)."""
        if self._all is None:
            return   # the caller dealt this process's records itself
        self._data = self._all[index::count]
        self._order = np.arange(len(self._data))

    def is_distributed(self) -> bool:
        return True

    def to_distributed(self) -> "DistributedDataSet":
        return self


def epoch_batches(dataset) -> Optional[int]:
    """The iterations one epoch of ``dataset`` yields, or None when it
    cannot be told without reading the epoch: a dataset's own
    ``batches_per_epoch()``; an in-memory set's records (each one an
    iteration); a transformed set's records through per-record stages and
    ``SampleToBatch`` (any other aggregating stage: None)."""
    own = getattr(dataset, "batches_per_epoch", None)
    if callable(own):
        return own()
    if isinstance(dataset, LocalDataSet):
        return dataset.size()
    if isinstance(dataset, TransformedDataSet):
        n = dataset.base.size()
        for stage in _flatten_chain(dataset.transformer):
            if isinstance(stage, SampleToBatch):
                full, rest = divmod(n, stage.batch_size)
                n = full + (1 if rest and not stage.drop_remainder else 0)
            elif stage.aggregating:
                return None
        return n
    return None


class DataSet:
    """Factory namespace (reference ``DataSet``)."""

    @staticmethod
    def array(data: Sequence, distributed: bool = False,
              seed: Optional[int] = None) -> LocalDataSet:
        """An in-memory dataset whose shuffles draw from ``seed``;
        ``distributed``: this process's slice (``DistributedDataSet``),
        which ``Optimizer`` trains data-parallel."""
        if distributed:
            return DistributedDataSet(data, seed=seed)
        return LocalDataSet(data, seed)

    @staticmethod
    def sort(data: Sequence, key=lambda s: s.feature.shape[0],
             distributed: bool = False, seed: Optional[int] = None):
        """``DataSet.array`` of ``data`` ordered by ``key`` (by default a
        sample's length): length bucketing for variable-length samples
        (reference ``DataSet.sort``)."""
        return DataSet.array(sorted(data, key=key), distributed, seed)
