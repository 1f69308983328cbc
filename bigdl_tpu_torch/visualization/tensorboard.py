"""TensorBoard event files: TFRecord framing, CRC32C, the queued writer and
the reader (counterpart of ``bigdl_tpu/visualization/tensorboard.py``).

Record framing (TFRecord):

    uint64 length (LE) | uint32 masked_crc32c(length bytes) |
    data bytes         | uint32 masked_crc32c(data)

masked_crc = rotr15(crc32c(x)) + 0xa282ead8 (mod 2^32). CRC32C is a
byte-wise loop over a table built with numpy; the events it guards are
small (a scalar event is about 40 bytes).
"""

from __future__ import annotations

import logging
import os
import queue
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.visualization import proto

_MASK_DELTA = 0xA282EAD8
_CRC_TABLE: Optional[List[int]] = None


def _crc_table() -> List[int]:
    """The reflected Castagnoli table (polynomial 0x82F63B78)."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        c = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            c = np.where(c & 1, (c >> 1) ^ np.uint32(0x82F63B78), c >> 1)
        _CRC_TABLE = [int(v) for v in c]
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli), as the reference's."""
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


class RecordWriter:
    """Frames byte payloads as TFRecords (reference ``RecordWriter``)."""

    def __init__(self, fileobj):
        self._f = fileobj

    def write(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))

    def flush(self) -> None:
        self._f.flush()


class EventWriter:
    """Queued event writer: a background thread writes each event and
    flushes every ``flush_secs`` (reference ``EventWriter``). ``close``
    drains the queue, flushes, joins the thread and closes the file."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, log_dir: str, flush_secs: float = 2.0,
                 filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        # the pid and a per-process number keep two writers opened in the
        # same second from truncating each other's file
        with EventWriter._seq_lock:
            EventWriter._seq += 1
            seq = EventWriter._seq
        fname = (f"events.out.tfevents.{int(time.time())}"
                 f".{os.uname().nodename}.{os.getpid()}.{seq}{filename_suffix}")
        self.path = os.path.join(log_dir, fname)
        self._file = open(self.path, "wb")
        self._writer = RecordWriter(self._file)
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._flush_secs = flush_secs
        self._closed = False
        self._dead = False   # set by the thread on an IO error
        # the first record is the file-version event, as TF's writers emit
        self._writer.write(proto.encode_event(
            wall_time=time.time(), file_version="brain.Event:2"))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bigdl-event-writer")
        self._thread.start()

    def add_event(self, event: bytes) -> None:
        if not self._closed and not self._dead:
            self._queue.put(event)

    def _run(self) -> None:
        last_flush = time.time()
        while True:
            timeout = max(0.01, self._flush_secs - (time.time() - last_flush))
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                item = b""
            if item is None:
                break
            try:
                if item:
                    self._writer.write(item)
                if time.time() - last_flush >= self._flush_secs:
                    self._writer.flush()
                    last_flush = time.time()
            except OSError as e:
                # a full disk or a closed file: producers stop queueing,
                # the thread drains until close
                if not self._dead:
                    logging.getLogger("bigdl_tpu_torch.visualization").error(
                        "event writer failed for %s: %s", self.path, e)
                    self._dead = True
        try:
            self._writer.flush()
        except OSError:
            pass

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            self._thread.join()
            self._file.close()


class FileWriter:
    """The user-facing writer (reference ``FileWriter``)."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        self.log_dir = log_dir
        self._event_writer = EventWriter(log_dir, flush_secs)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._event_writer.add_event(proto.encode_event(
            wall_time=time.time(), step=int(step),
            summary_values=[proto.encode_scalar_value(tag, float(value))]))

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._event_writer.add_event(proto.encode_event(
            wall_time=time.time(), step=int(step),
            summary_values=[proto.encode_histo_value(tag, np.asarray(values))]))

    def close(self) -> None:
        self._event_writer.close()


class FileReader:
    """Reads event files back (reference ``FileReader``)."""

    @staticmethod
    def list_event_files(log_dir: str) -> List[str]:
        return sorted(os.path.join(log_dir, f) for f in os.listdir(log_dir)
                      if f.startswith("events.out.tfevents"))

    @staticmethod
    def read_records(path: str, validate_crc: bool = True) -> Iterator[bytes]:
        """Each record's payload; a bad CRC raises ``IOError``, a truncated
        tail (a writer that died) ends the file."""
        with open(path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    return
                (length,) = struct.unpack("<Q", header)
                hcrc_bytes = f.read(4)
                if len(hcrc_bytes) < 4:
                    return
                (hcrc,) = struct.unpack("<I", hcrc_bytes)
                if validate_crc and masked_crc32c(header) != hcrc:
                    raise IOError(f"corrupt record header in {path}")
                data = f.read(length)
                dcrc_bytes = f.read(4)
                if len(data) < length or len(dcrc_bytes) < 4:
                    return
                (dcrc,) = struct.unpack("<I", dcrc_bytes)
                if validate_crc and masked_crc32c(data) != dcrc:
                    raise IOError(f"corrupt record payload in {path}")
                yield data

    @classmethod
    def read_scalar(cls, log_dir_or_file: str, tag: str
                    ) -> List[Tuple[int, float, float]]:
        """Every ``(step, value, wall_time)`` of ``tag``, by step."""
        if os.path.isdir(log_dir_or_file):
            files = cls.list_event_files(log_dir_or_file)
        else:
            files = [log_dir_or_file]
        out: List[Tuple[int, float, float]] = []
        for path in files:
            for record in cls.read_records(path):
                ev = proto.decode_event(record)
                for t, v in ev["scalars"]:
                    if t == tag:
                        out.append((ev["step"], v, ev["wall_time"]))
        out.sort(key=lambda x: (x[0], x[2]))
        return out
