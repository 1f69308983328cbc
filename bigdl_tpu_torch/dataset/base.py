"""Core data-pipeline types (counterpart of ``bigdl_tpu/dataset/base.py``:
``Sample``, ``MiniBatch``, ``ByteRecord``, ``Transformer`` with ``>>``,
``SampleToBatch``, ``Prefetch``, ``LocalDataSet``, ``TransformedDataSet``
and ``DataSet.array`` are ported).

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
    """Iterator-to-iterator stage (reference ``Transformer``)."""

    def __call__(self, prev: Iterator) -> Iterator:
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)


class ChainedTransformer(Transformer):
    """Two stages in a row (the reference's ``->`` combinator)."""

    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def __call__(self, prev: Iterator) -> Iterator:
        return self.second(self.first(prev))


class SampleToBatch(Transformer):
    """Stack Samples into MiniBatches of ``batch_size`` (reference
    ``SampleToBatch``; the padding options are not ported). With
    ``drop_remainder`` a short last batch is dropped, else emitted."""

    def __init__(self, batch_size: int, drop_remainder: bool = True):
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder

    def __call__(self, prev: Iterator[Sample]) -> Iterator[MiniBatch]:
        buf: List[Sample] = []
        for s in prev:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self._collate(buf)

    @staticmethod
    def _collate(samples: List[Sample]) -> MiniBatch:
        feats = np.stack([s.feature for s in samples])
        labs = np.stack([s.label for s in samples])
        if labs.ndim == 2 and labs.shape[1] == 1:
            labs = labs[:, 0]
        return MiniBatch(feats, labs)


class Prefetch(Transformer):
    """Stage up to ``depth`` upstream items in a background thread, so the
    host's decode, augmentation and collation overlap the card's step
    (reference ``Prefetch``); placed last, after batching:
    ``... >> BGRImgToBatch(256) >> Prefetch(2)``. Items keep their order;
    an upstream exception is raised in the consumer.

    In the reference it must not sit below a device-cached dataset (the
    cache would freeze what it prefetched); the port has no device cache
    yet."""

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


class DataSet:
    """Factory namespace (reference ``DataSet``)."""

    @staticmethod
    def array(data: Sequence, distributed: bool = False,
              seed: Optional[int] = None) -> LocalDataSet:
        """An in-memory dataset whose shuffles draw from ``seed``."""
        if distributed:
            raise NotImplementedError(
                "distributed datasets are not ported yet: ROADMAP A.4 "
                "(distributed plane)")
        return LocalDataSet(data, seed)
