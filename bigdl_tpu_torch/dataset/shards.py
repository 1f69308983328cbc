"""Packed record shards, the ImageNet-scale ingest path (counterpart of
``bigdl_tpu/dataset/shards.py``; BigDL's ``DataSet.SeqFileFolder`` and
``ImageNetSeqFileGenerator.scala`` pack image bytes into Hadoop
SequenceFiles).

A shard is a local file of TFRecord-framed records (length, masked CRC32C,
payload, masked CRC32C; ``visualization.tensorboard.RecordWriter``), one
record per (label, bytes) pair: the label as a little-endian f32, then the
bytes. The same records give the same file from either package, and each
reads the other's. ``read_shard`` indexes and checks a whole shard in one
call into the host library (``native.shard_scan``); without a compiler it
frames the records in Python (``FileReader.read_records``), with the same
refusals. Shards are split between hosts round-robin by ``host_index``.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Sequence

from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset.base import (AbstractDataSet, ByteRecord,
                                          DistributedDataSet, Transformer)
from bigdl_tpu_torch.visualization.tensorboard import FileReader, RecordWriter

_SUFFIX = ".bigdl-shard"


class ShardWriter:
    """Write (label, payload) records into shards of ``records_per_shard``
    records each, named ``{path_prefix}-{index:05d}.bigdl-shard`` (reference
    ``ShardWriter``; BigDL's ``BGRImgToLocalSeqFile``)."""

    def __init__(self, path_prefix: str, records_per_shard: int = 1024):
        self.path_prefix = path_prefix
        self.records_per_shard = records_per_shard
        self._shard_idx = 0
        self._in_shard = 0
        self._file = None
        self._writer: Optional[RecordWriter] = None
        self.written_paths: List[str] = []
        os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)

    def _roll(self) -> None:
        if self._file is not None:
            self._file.close()
        path = f"{self.path_prefix}-{self._shard_idx:05d}{_SUFFIX}"
        self._file = open(path, "wb")
        self._writer = RecordWriter(self._file)
        self.written_paths.append(path)
        self._shard_idx += 1
        self._in_shard = 0

    def write(self, label: float, payload: bytes) -> None:
        if self._writer is None or self._in_shard >= self.records_per_shard:
            self._roll()
        self._writer.write(struct.pack("<f", float(label)) + payload)
        self._in_shard += 1

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        self._writer = None   # a later write() rolls a fresh shard

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def list_shards(folder: str) -> List[str]:
    return sorted(os.path.join(folder, f) for f in os.listdir(folder)
                  if f.endswith(_SUFFIX))


def _native_scan(path: str):
    """``(buf, [(offset, length), ...])`` over a shard's payloads, every CRC
    checked in one call into the host library; None without it."""
    with open(path, "rb") as f:
        buf = f.read()
    # an index sized for KB-scale records first; the worst case (16 bytes
    # of framing around empty payloads) only when that runs out
    worst = len(buf) // 16 + 1
    cap = max(1024, min(len(buf) // 4096 + 1, worst))
    while True:
        scanned = native.shard_scan(buf, cap)
        if scanned is None:
            return None
        n, offs, lens = scanned
        if n != native.SCAN_FULL:
            break
        cap = worst
    if n == native.SCAN_CORRUPT_HEADER:
        raise IOError(f"corrupt record header in {path}")
    if n == native.SCAN_CORRUPT_PAYLOAD:
        raise IOError(f"corrupt record payload in {path}")
    if n < 0:
        raise IOError(f"shard scan failed ({n}) in {path}")
    return buf, list(zip(offs.tolist(), lens.tolist()))


def _count_records(path: str) -> int:
    """The record count by a framing walk that reads 12 bytes a record and
    seeks over the payloads (no CRC; a truncated tail ends the count, as
    it ends ``read_shard``)."""
    total = os.path.getsize(path)
    count = 0
    with open(path, "rb") as f:
        pos = 0
        while total - pos >= 12:
            header = f.read(12)
            if len(header) < 12:
                break
            (length,) = struct.unpack_from("<Q", header)
            body = pos + 12
            if length > total - body or total - body - length < 4:
                break
            count += 1
            pos = body + length + 4
            f.seek(pos)
    return count


def _short(length: int, path: str) -> IOError:
    return IOError(f"record shorter than its 4-byte label ({length}B) in "
                   f"{path}")


def read_shard_plain(path: str) -> Iterator[ByteRecord]:
    """``read_shard`` framed in Python, record by record."""
    for record in FileReader.read_records(path):
        if len(record) < 4:
            raise _short(len(record), path)
        (label,) = struct.unpack("<f", record[:4])
        yield ByteRecord(record[4:], label)


def read_shard(path: str) -> Iterator[ByteRecord]:
    """A shard's records; raises ``IOError`` on a corrupt header or payload
    CRC, and ends at a truncated tail (a writer that died mid-record)."""
    scanned = _native_scan(path)
    if scanned is None:
        yield from read_shard_plain(path)
        return
    buf, index = scanned
    for off, length in index:
        if length < 4:
            raise _short(length, path)
        (label,) = struct.unpack_from("<f", buf, off)
        yield ByteRecord(buf[off + 4:off + length], label)


def _process_slot():
    """(index, count) of this process: its ``torch.distributed`` rank and
    world size when a process group is up, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardFolder:
    """reference ``ShardFolder`` (BigDL's ``SeqFileFolder.files``)."""

    @staticmethod
    def paths(folder: str, host_index: Optional[int] = None,
              host_count: Optional[int] = None) -> List[str]:
        """This host's shards: every ``host_count``-th from ``host_index``.
        The default is this process's slot in the ``torch.distributed``
        group, or the only host without one."""
        if host_index is None or host_count is None:
            host_index, host_count = _process_slot()
        return list_shards(folder)[host_index::host_count]

    @staticmethod
    def files(folder: str, host_index: Optional[int] = None,
              host_count: Optional[int] = None) -> DistributedDataSet:
        """Every record of this host's shards, in memory (for small
        folders; ``stream`` holds one shard at a time), as a
        ``DistributedDataSet`` that keeps them all: they are this
        process's already."""
        records: List[ByteRecord] = []
        for path in ShardFolder.paths(folder, host_index, host_count):
            records.extend(read_shard(path))
        return DistributedDataSet(records, shard_by_process=False)

    @staticmethod
    def stream(folder: str, host_index: Optional[int] = None,
               host_count: Optional[int] = None) -> "StreamingShardDataSet":
        """This host's shards, read from disk one at a time each epoch."""
        return StreamingShardDataSet(
            ShardFolder.paths(folder, host_index, host_count))


class StreamingShardDataSet(AbstractDataSet):
    """A dataset over shard files, read again every epoch (reference
    ``StreamingShardDataSet``). ``shuffle`` permutes the shard order and
    turns on shuffling of the records within the one resident shard; both
    draw from ``RandomGenerator.RNG()`` as the reference's do. Evaluation
    reads in disk order.

    The paths are this process's already (``ShardFolder.paths`` deals the
    shard files by rank), so ``is_distributed`` is true, as the
    reference's: ``Optimizer`` trains it through ``DistriOptimizer``
    over a process group of more than one, and through ``LocalOptimizer``
    in a single process."""

    def __init__(self, paths: Sequence[str]):
        self._paths = list(paths)
        self._order = list(range(len(self._paths)))
        self._size: Optional[int] = None
        self._shuffled = False

    def data(self, train: bool) -> Iterator[ByteRecord]:
        from bigdl_tpu_torch.utils.rng import RandomGenerator
        order = self._order if train else range(len(self._paths))
        for i in order:
            records = list(read_shard(self._paths[i]))
            if train and self._shuffled:
                RandomGenerator.RNG().shuffle(records)
            yield from records

    def size(self) -> int:
        if self._size is None:
            self._size = sum(_count_records(p) for p in self._paths)
        return self._size

    def shuffle(self) -> None:
        from bigdl_tpu_torch.utils.rng import RandomGenerator
        RandomGenerator.RNG().shuffle(self._order)
        self._shuffled = True

    def is_distributed(self) -> bool:
        return True   # the paths are this process's


class BGRImgToLocalSeqFile(Transformer):
    """Pack labelled images as uint8 pixels into shards, yielding the paths
    written (reference ``BGRImgToLocalSeqFile``). Pack before normalising:
    a pixel outside [0, 255] raises."""

    aggregating = True   # many images to one path

    def __init__(self, path_prefix: str, block_size: int = 1024):
        self.path_prefix = path_prefix
        self.block_size = block_size

    def __call__(self, prev):
        import numpy as np
        with ShardWriter(self.path_prefix,
                         records_per_shard=self.block_size) as writer:
            for img in prev:
                data = np.asarray(img.data)
                if data.min() < 0 or data.max() > 255:
                    raise ValueError(
                        "image pixels outside [0, 255] cannot be packed as "
                        "uint8 — write raw images, normalize on the read "
                        f"side (got range [{data.min()}, {data.max()}])")
                writer.write(img.label, data.astype(np.uint8).tobytes())
        yield from writer.written_paths


class LocalSeqFileToBytes(Transformer):
    """Shard paths to their records (reference ``LocalSeqFileToBytes``)."""

    def __call__(self, prev) -> Iterator[ByteRecord]:
        for path in prev:
            yield from read_shard(path)
