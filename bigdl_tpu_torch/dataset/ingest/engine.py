"""Staged, threaded ingest engine (counterpart of
``bigdl_tpu/dataset/ingest/engine.py``): read / decode / device-feed as
overlapping stages connected by bounded queues, in the reference's order.

The serial host chain (shard read -> decode -> collate -> copy to the card
-> step) runs every stage on the consumer thread, so each stage's latency
adds. Each link can release the interpreter lock: shard reads are file IO,
the whole-batch decode is a ``ctypes`` call into the host library
(``native``, ``NativeBGRBatchDecoder``), the copy to the card an
asynchronous copy; so Python threads overlap them, and per-record Python
stays out of the stage threads. What a naive pool loses is *order*, and
with it shuffle replay and mid-epoch resume; the engine keeps both:

- **read pool**: N reader threads take ``(seq, path, seed)`` shard tasks,
  read and CRC-check the shard, apply the per-shard record shuffle from
  the task's seed (drawn by the *constructing* thread: ``RandomGenerator``
  is per thread, so worker-side draws would depend on scheduling), and
  land the record list in a sequence-numbered ``ReorderBuffer``.
- **collate feeder**: one thread restores shard order, cuts the record
  stream into batch-size chunks, and tickets them into the decode pool.
- **decode pool**: M threads, each with its own ``clone_transformer()`` of
  the chain (per-worker native staging buffers), run whole chunks through
  it; outputs reorder by chunk sequence.
- **device feed**: one thread pops ordered batches and copies each to the
  card ahead of use: the host arrays go into a pinned staging buffer (a
  ring per shape, a buffer refilled only after the event of its last copy
  has completed), then to a fresh device tensor with ``non_blocking=True``
  on a side CUDA stream, and an event is recorded behind the copy. The
  consumer's ``next`` makes its current stream wait on that event, and the
  device tensors are ``record_stream``-ed on that stream, so the caching
  allocator does not hand their memory out again while the step still
  reads it: batch N+1 is copied while step N computes. With
  ``IngestConfig(device="cpu")`` the feed hands host tensors over and uses
  no stream.

Memory is bounded end to end: resident shards by a reader semaphore
(released when the collate feeder finishes a shard), in-flight chunks by
an admission-ticket semaphore (released when the device feed pops the
ordered result), handed-off batches by the output queue's
``prefetch_depth``. A stalled consumer therefore freezes the pipeline at a
fixed footprint instead of buffering the epoch.

Every stage is instrumented (``bigdl_ingest_*``) and span-traced
(``ingest.read_shard`` / ``ingest.decode`` / ``ingest.device_put``);
``bigdl_ingest_stall_seconds_total{stage}`` names the starved stage: a
stage's input wait counts as a stall only when the pipeline had admission
room (otherwise the wait is backpressure from below, charged to nobody).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.base import Transformer, _flatten_chain
from bigdl_tpu_torch.dataset.ingest.reorder import ReorderBuffer
from bigdl_tpu_torch.telemetry import get_registry, instruments, span

__all__ = ["IngestConfig", "IngestEngine", "validate_chain"]

_END = object()

_WAIT_SLICE_S = 0.05


class IngestConfig:
    """Knobs of the staged engine (defaults suit a few-core host)."""

    __slots__ = ("workers", "decode_workers", "prefetch_depth",
                 "resident_shards", "inflight_chunks", "device_put",
                 "chunk_records", "device")

    def __init__(self, workers: int = 2,
                 decode_workers: Optional[int] = None,
                 prefetch_depth: int = 2,
                 resident_shards: Optional[int] = None,
                 inflight_chunks: Optional[int] = None,
                 device_put: bool = True,
                 chunk_records: int = 256,
                 device="cuda"):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}")
        self.workers = int(workers)
        self.decode_workers = int(decode_workers if decode_workers
                                  else workers)
        self.prefetch_depth = int(prefetch_depth)
        # one shard resident per reader plus one being collated mirrors
        # StreamingShardDataSet's max-shard-size memory bound, scaled by
        # the worker count
        self.resident_shards = int(resident_shards if resident_shards
                                   else self.workers + 1)
        self.inflight_chunks = int(
            inflight_chunks if inflight_chunks
            else self.decode_workers + self.prefetch_depth + 1)
        self.device_put = bool(device_put)
        # chunk size when no batching stage dictates one (records pass
        # through unbatched, e.g. the determinism tests)
        self.chunk_records = int(chunk_records)
        # where the device feed puts batches: the card by default, the CPU
        # (host tensors, no stream) when asked
        self.device = device


def validate_chain(chain: Optional[Transformer]) -> Tuple[
        List[Transformer], Optional[Transformer]]:
    """Split a decode chain into (per-record stages, trailing batcher).

    The engine fans whole chunks out to decode workers, so the chain must
    be order-deterministic and chunk-alignable: no ``stochastic`` stages
    (their thread-local RNG draws would depend on worker scheduling —
    keep random augmentation above the engine), per-record stages must be
    1:1, and at most one ``aggregating`` stage, in trailing position,
    carrying an integer ``batch_size`` (chunks are cut to exactly that
    size, so per-chunk collation equals whole-stream collation).
    """
    if chain is None:
        return [], None
    stages = _flatten_chain(chain)
    for s in stages:
        if getattr(s, "stochastic", False):
            raise ValueError(
                f"ingest engine cannot pipeline the stochastic stage "
                f"{type(s).__name__}: worker-thread RNG draws are "
                "schedule-dependent, which breaks the bit-exact ordering "
                "contract. Apply random augmentation above the engine.")
    for s in stages[:-1]:
        if getattr(s, "aggregating", False):
            raise ValueError(
                f"ingest engine needs the aggregating stage "
                f"{type(s).__name__} in trailing position (chunks are "
                "cut to its batch_size; a mid-chain aggregator would "
                "see chunk boundaries).")
    batcher = None
    if stages and getattr(stages[-1], "aggregating", False):
        batcher = stages[-1]
        if not isinstance(getattr(batcher, "batch_size", None), int):
            raise ValueError(
                f"trailing aggregating stage {type(batcher).__name__} "
                "must expose an integer .batch_size so the engine can "
                "align chunks to batch boundaries")
        stages = stages[:-1]
    return stages, batcher


def _rechain(stages: Sequence[Transformer],
             batcher: Optional[Transformer]) -> Optional[Transformer]:
    out: Optional[Transformer] = None
    for s in list(stages) + ([batcher] if batcher is not None else []):
        out = s if out is None else (out >> s)
    return out


class IngestEngine:
    """One epoch of pipelined ingest over an ordered shard task list.

    ``tasks`` is ``[(path, seed), ...]`` in epoch order (seed ``None``
    for disk order); ``read_fn(path)`` yields the shard's records.
    Iterate the engine to consume ordered batches; ``close()`` (also
    called automatically at end of stream and by ``__exit__``) drains and
    joins every worker thread — no leaks on exception paths.
    """

    def __init__(self, tasks: Sequence[Tuple[str, Optional[int]]],
                 read_fn, chain: Optional[Transformer] = None,
                 config: Optional[IngestConfig] = None):
        self.config = cfg = config or IngestConfig()
        self._feed = _DeviceFeed(cfg.device) if cfg.device_put else None
        self._read_fn = read_fn
        stages, batcher = validate_chain(chain)
        self._stages = stages
        self._batcher = batcher
        self._chunk_size = (batcher.batch_size if batcher is not None
                            else cfg.chunk_records)
        self._tasks = list(tasks)
        ins = instruments(get_registry())
        self._m_depth = ins.ingest_queue_depth
        self._m_stage = ins.ingest_stage_seconds
        self._m_records = ins.ingest_records_total
        self._m_bytes = ins.ingest_bytes_total
        self._m_batches = ins.ingest_batches_total
        self._m_stall = ins.ingest_stall_seconds_total

        self._stop = threading.Event()
        # guards _error, _closed, _inflight_chunks (written by worker
        # threads AND the consumer thread)
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._closed = False
        self._inflight_chunks = 0

        self._task_q: "queue.Queue" = queue.Queue()
        for seq, (path, seed) in enumerate(self._tasks):
            self._task_q.put((seq, path, seed))
        for _ in range(cfg.workers):
            self._task_q.put(_END)
        self._shard_sem = threading.Semaphore(cfg.resident_shards)
        self._shard_ro = ReorderBuffer()
        self._chunk_q: "queue.Queue" = queue.Queue()
        self._chunk_sem = threading.Semaphore(cfg.inflight_chunks)
        self._batch_ro = ReorderBuffer()
        self._out_q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch_depth)

        self._threads: List[threading.Thread] = []
        for i in range(cfg.workers):
            self._spawn(self._read_loop, f"bigdl-ingest-read-{i}")
        self._spawn(self._collate_loop, "bigdl-ingest-collate")
        for i in range(cfg.decode_workers):
            self._spawn(self._decode_loop, f"bigdl-ingest-decode-{i}",
                        (i,))
        self._spawn(self._feed_loop, "bigdl-ingest-feed")

    # ------------------------------------------------------------ lifecycle
    def _spawn(self, target, name: str, args: tuple = ()) -> None:
        t = threading.Thread(target=target, name=name, args=args,
                             daemon=True)
        self._threads.append(t)
        t.start()

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = exc
        self._stop.set()

    def close(self) -> None:
        """Drain + join every stage thread. Idempotent; safe to call from
        ``finally`` blocks, the consumer, or the preemption drain path."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        # poke ticket waiters so blocked stages re-check the stop event
        self._shard_sem.release()
        self._chunk_sem.release()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = [t for t in self._threads if t.is_alive()]
        # closed means CLOSED: drop already-buffered output so a drained
        # iterator ends at once instead of replaying stale prefetch (the
        # preemption path must not hand batches past the snapshot cursor)
        while True:
            try:
                self._out_q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "IngestEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def inflight_chunks(self) -> int:
        """Chunks admitted but not yet released to the output queue (the
        quantity the admission tickets bound; backpressure tests poll
        it)."""
        with self._lock:
            return self._inflight_chunks

    # ----------------------------------------------------- blocking helpers
    def _acquire(self, sem: threading.Semaphore) -> bool:
        while not self._stop.is_set():
            if sem.acquire(timeout=_WAIT_SLICE_S):
                return True
        return False

    def _get(self, q: "queue.Queue", stage: str,
             count_stall: bool = True):
        """Stop-aware ``q.get`` charging the wait to the stage's stall
        counter (only while admission room exists — a full pipeline means
        the wait is downstream backpressure, not upstream starvation)."""
        t0 = time.perf_counter()
        while not self._stop.is_set():
            try:
                item = q.get(timeout=_WAIT_SLICE_S)
            except queue.Empty:
                continue
            waited = time.perf_counter() - t0
            if count_stall and waited > 0 and item is not _END:
                with self._lock:
                    starved = (self._inflight_chunks
                               < self.config.inflight_chunks)
                if starved:
                    self._m_stall.labels(stage=stage).inc(waited)
            return item
        return _END

    def _put(self, q: "queue.Queue", item: Any) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=_WAIT_SLICE_S)
                return True
            except queue.Full:
                continue
        return False

    # --------------------------------------------------------------- stages
    def _read_loop(self) -> None:
        try:
            while True:
                item = self._get(self._task_q, "read", count_stall=False)
                if item is _END:
                    return
                seq, path, seed = item
                if not self._acquire(self._shard_sem):
                    return
                t0 = time.perf_counter()
                with span("ingest.read_shard", seq=seq):
                    records = list(self._read_fn(path))
                    if seed is not None:
                        # seeded worker-local generator: the draw depends
                        # only on (epoch seed, shard seq), never on which
                        # worker or in what order shards complete
                        np.random.default_rng(seed).shuffle(records)
                self._m_stage.labels(stage="read").observe(
                    time.perf_counter() - t0)
                self._m_bytes.inc(sum(len(r.data) for r in records
                                      if hasattr(r, "data")
                                      and isinstance(r.data, bytes)))
                if not self._shard_ro.put(seq, records, self._stop):
                    return
                self._m_depth.labels(stage="shards").set(
                    self._shard_ro.pending())
        except BaseException as e:
            self._fail(e)

    def _collate_loop(self) -> None:
        try:
            chunk_seq = 0
            buf: List[Any] = []
            for _ in range(len(self._tasks)):
                t0 = time.perf_counter()
                records = self._shard_ro.pop(self._stop)
                waited = time.perf_counter() - t0
                if records is None:
                    return  # stopped mid-epoch
                if waited > 0:
                    with self._lock:
                        starved = (self._inflight_chunks
                                   < self.config.inflight_chunks)
                    if starved:
                        self._m_stall.labels(stage="collate").inc(waited)
                buf.extend(records)
                self._shard_sem.release()
                while len(buf) >= self._chunk_size:
                    chunk, buf = (buf[:self._chunk_size],
                                  buf[self._chunk_size:])
                    if not self._submit_chunk(chunk_seq, chunk):
                        return
                    chunk_seq += 1
            if buf:
                if not self._submit_chunk(chunk_seq, buf):
                    return
                chunk_seq += 1
            self._batch_ro.close(chunk_seq)
            for _ in range(self.config.decode_workers):
                self._put(self._chunk_q, _END)
        except BaseException as e:
            self._fail(e)

    def _submit_chunk(self, seq: int, chunk: List[Any]) -> bool:
        if not self._acquire(self._chunk_sem):
            return False
        with self._lock:
            self._inflight_chunks += 1
        ok = self._put(self._chunk_q, (seq, chunk))
        self._m_depth.labels(stage="chunks").set(self._chunk_q.qsize())
        return ok

    def _decode_loop(self, worker: int) -> None:
        try:
            import copy
            chain = _rechain([s.clone_transformer() for s in self._stages],
                             copy.deepcopy(self._batcher)
                             if self._batcher is not None else None)
            while True:
                item = self._get(self._chunk_q, "decode")
                if item is _END:
                    return
                seq, chunk = item
                t0 = time.perf_counter()
                with span("ingest.decode", seq=seq, worker=worker,
                          records=len(chunk)):
                    outs = (list(chain(iter(chunk))) if chain is not None
                            else [chunk])
                self._m_stage.labels(stage="decode").observe(
                    time.perf_counter() - t0)
                if not self._batch_ro.put(seq, outs, self._stop):
                    return
                self._m_depth.labels(stage="batches").set(
                    self._batch_ro.pending())
        except BaseException as e:
            self._fail(e)

    def _feed_loop(self) -> None:
        try:
            while True:
                t0 = time.perf_counter()
                outs = self._batch_ro.pop(self._stop)
                waited = time.perf_counter() - t0
                if outs is None:
                    if self._stop.is_set():
                        return
                    self._put(self._out_q, _END)
                    return
                if waited > 0:
                    # the feed has no downstream admission stage: an input
                    # wait here is always upstream starvation
                    self._m_stall.labels(stage="device_put").inc(waited)
                for b in outs:
                    placed = self._place(b)
                    if not self._put(self._out_q, placed):
                        return
                    self._m_depth.labels(stage="out").set(
                        self._out_q.qsize())
                with self._lock:
                    self._inflight_chunks -= 1
                self._chunk_sem.release()
        except BaseException as e:
            self._fail(e)

    def _place(self, batch):
        """The batch on the feed's device: copied without blocking on the
        feed's stream, with the event the consumer waits on."""
        data = getattr(batch, "data", None)
        labels = getattr(batch, "labels", None)
        if (self._feed is None or not isinstance(data, np.ndarray)
                or labels is None):
            return batch, None
        t0 = time.perf_counter()
        with span("ingest.device_put", bytes=int(data.nbytes)):
            (data_t, labels_t), event = self._feed.put(
                (data, np.asarray(labels)))
        self._m_stage.labels(stage="device_put").observe(
            time.perf_counter() - t0)
        return type(batch)(data_t, labels_t), event

    # ------------------------------------------------------------- consumer
    def __iter__(self) -> "IngestEngine":
        return self

    def __next__(self):
        t0 = time.perf_counter()
        while True:
            with self._lock:
                err = self._error
            if err is not None:
                self.close()
                raise err
            try:
                item = self._out_q.get(timeout=_WAIT_SLICE_S)
                break
            except queue.Empty:
                with self._lock:
                    dead = self._closed
                if dead:
                    raise StopIteration
                continue
        waited = time.perf_counter() - t0
        if item is _END:
            self.close()
            raise StopIteration
        item, event = item      # the batch as placed, and its copy's event
        if event is not None:
            self._feed.hand_over(item, event)
        if waited > 0:
            # the training loop's data wait, attributed: ingest could not
            # keep the step fed
            self._m_stall.labels(stage="step").inc(waited)
        self._m_batches.inc()
        size = getattr(item, "size", None)
        if callable(size):
            try:
                self._m_records.inc(int(size()))
            except TypeError:
                self._m_records.inc(len(item))
        elif isinstance(item, list):
            self._m_records.inc(len(item))
        return item


class _DeviceFeed:
    """The device feed's copies (see the module docstring): a side stream
    of the device, pinned staging buffers in a ring per (shape, dtype),
    each with the event of its last copy; ``hand_over`` runs on the
    consumer's thread."""

    RING = 4

    def __init__(self, device):
        import torch

        from bigdl_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self.consumer = torch.cuda.current_stream(self.device)
        self._rings: dict = {}

    def _staging(self, arr: np.ndarray):
        """A pinned buffer for ``arr``, whose previous copy has finished."""
        import torch
        key = (arr.shape, arr.dtype.str)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = {"i": 0, "slots": [
                [torch.empty(arr.shape, dtype=torch.from_numpy(arr).dtype,
                             pin_memory=True), None]
                for _ in range(self.RING)]}
        slot = ring["slots"][ring["i"]]
        ring["i"] = (ring["i"] + 1) % self.RING
        if slot[1] is not None:
            slot[1].synchronize()   # its last copy has left the buffer
        return slot

    def put(self, arrays):
        """(tensors on the device, event behind their copies)."""
        import torch
        if not self.cuda:
            return tuple(torch.from_numpy(a) for a in arrays), None
        out = []
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            slots = []
            for a in arrays:
                slot = self._staging(a)
                slot[0].numpy()[...] = a
                out.append(slot[0].to(self.device, non_blocking=True))
                slots.append(slot)
            event = torch.cuda.Event()
            event.record(self.stream)
            for slot in slots:
                slot[1] = event
        return tuple(out), event

    def hand_over(self, batch, event) -> None:
        """On the consumer's thread: its stream waits for the copies, and
        the device tensors are marked as used by it, so their memory (the
        feed stream's) is not reused while the step reads them."""
        import torch
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in (batch.data, batch.labels):
            t.record_stream(stream)
