"""The staged ingest engine of the port (``bigdl_tpu_torch/dataset/ingest``)
against the reference's (``bigdl_tpu/dataset/ingest``) on the CPU:

- the port's ``PrefetchingDataSet``, pipelined and serial, hands out the
  same records and batches in the same order as the reference's from the
  same shard files and seed, epoch after epoch, exactly;
- ``drain()`` joins every stage thread within 5 s; a stalled consumer
  holds the in-flight chunks at their bound; a reader's exception reaches
  the consumer; stalls are charged by stage;
- the device feed with ``device="cpu"`` hands host tensors over; the
  training loop consumes the engine, and its preemption path runs the
  dataset's drain hook (the port's loop did not register it before).
"""

import signal
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset.image import NativeBGRBatchDecoder as RefDecoder
from bigdl_tpu.dataset.ingest import IngestConfig as RefConfig
from bigdl_tpu.dataset.ingest import PrefetchingDataSet as RefDataSet
from bigdl_tpu.utils.rng import RandomGenerator as RefRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.image import NativeBGRBatchDecoder
from bigdl_tpu_torch.dataset.ingest import (IngestConfig, IngestEngine,
                                            PrefetchingDataSet,
                                            ReorderBuffer, validate_chain)
from bigdl_tpu_torch.dataset.shards import (ShardFolder, ShardWriter,
                                            read_shard)
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.resilience import (KillAtStep, PreemptionHandler,
                                        TrainingPreempted)
from bigdl_tpu_torch.telemetry import (MetricsRegistry, get_registry,
                                       instruments, set_registry)
from bigdl_tpu_torch.utils.rng import RandomGenerator

N_SHARDS, PER_SHARD, SIDE = 5, 9, 4
REC = SIDE * SIDE * 3


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    folder = tmp_path_factory.mktemp("port_ingest")
    rng = np.random.default_rng(4)
    with ShardWriter(str(folder / "part"), records_per_shard=PER_SHARD) as w:
        for i in range(N_SHARDS * PER_SHARD):
            w.write(float(i % 3 + 1),
                    rng.integers(0, 256, REC, dtype=np.uint8).tobytes())
    return str(folder)


def _settle_threads(before, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        extra = set(threading.enumerate()) - before
        if not extra:
            return []
        time.sleep(0.02)
    return [t.name for t in set(threading.enumerate()) - before]


def _decoder(cls, normalize: bool):
    return cls(SIDE, SIDE, 4, mean=(127.5,) * 3, std=(73.0,) * 3,
               workers=2, device_normalize=not normalize)


def _epochs(ds, rng, epochs=2):
    out = []
    for _ in range(epochs):
        ds.shuffle()
        rows = []
        for item in ds.data(train=True):
            if hasattr(item, "labels"):
                rows.append((np.asarray(item.data).tobytes(),
                             np.asarray(item.labels).tolist()))
            else:
                rows.append((item.data, item.label))
        out.append(rows)
    return out


@pytest.mark.parametrize("chain", ["records", "uint8", "normalized"])
@pytest.mark.parametrize("serial", [False, True])
def test_same_batches_as_the_reference(corpus, chain, serial):
    def build(side):
        if side == "ref":
            dec = (None if chain == "records"
                   else _decoder(RefDecoder, chain == "normalized"))
            RefRNG.RNG().set_seed(9)
            return RefDataSet.from_folder(
                corpus, transformer=dec, serial=serial, host_index=0,
                host_count=1, config=RefConfig(workers=2, chunk_records=4,
                                               device_put=False))
        dec = (None if chain == "records"
               else _decoder(NativeBGRBatchDecoder, chain == "normalized"))
        RandomGenerator.RNG().set_seed(9)
        return PrefetchingDataSet.from_folder(
            corpus, transformer=dec, serial=serial,
            config=IngestConfig(workers=2, chunk_records=4, device="cpu"))
    ref, ours = build("ref"), build("port")
    RefRNG.RNG().set_seed(9)
    want = _epochs(ref, RefRNG.RNG())
    RandomGenerator.RNG().set_seed(9)
    got = _epochs(ours, RandomGenerator.RNG())
    assert got == want
    # the decoder drops a short tail batch, as the reference's does
    assert len(got[0]) == (N_SHARDS * PER_SHARD if chain == "records"
                           else N_SHARDS * PER_SHARD // 4)
    # this process's shard files, as the reference's: data-parallel
    assert ours.size() == N_SHARDS * PER_SHARD
    assert ours.is_distributed() and ref.is_distributed()


def test_cpu_feed_hands_host_tensors_over(corpus):
    ds = PrefetchingDataSet.from_folder(
        corpus, transformer=_decoder(NativeBGRBatchDecoder, False),
        config=IngestConfig(workers=2, device="cpu"))
    batches = list(ds.data(train=True))
    assert all(torch.is_tensor(b.data) and b.data.dtype == torch.uint8
               and b.data.device.type == "cpu" for b in batches)
    assert tuple(batches[0].data.shape) == (4, SIDE, SIDE, 3)


def test_reorder_buffer_releases_in_order():
    buf, stop = ReorderBuffer(), threading.Event()
    for seq in (2, 0, 3, 1):
        buf.put(seq, seq * 10, stop)
    buf.close(4)
    assert [buf.pop(stop) for _ in range(5)] == [0, 10, 20, 30, None]


def test_drain_joins_every_stage_thread(corpus):
    ds = PrefetchingDataSet.from_folder(
        corpus, config=IngestConfig(workers=3, chunk_records=4,
                                    device="cpu"))
    before = set(threading.enumerate())
    it = ds.data(train=True)
    next(it)
    ds.drain()
    assert _settle_threads(before, timeout=5.0) == []
    assert list(it) == []       # a drained iterator ends at once


def test_stalled_consumer_holds_inflight_chunks_at_the_bound(corpus):
    cfg = IngestConfig(workers=2, prefetch_depth=1, chunk_records=4,
                       inflight_chunks=3, device_put=False)
    tasks = [(p, None) for p in ShardFolder.paths(corpus)]
    before = set(threading.enumerate())
    with IngestEngine(tasks, read_shard, config=cfg) as eng:
        deadline = time.time() + 5.0
        while eng.inflight_chunks() < 3 and time.time() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)       # a leaked ticket would overshoot here
        assert eng.inflight_chunks() == cfg.inflight_chunks
        assert sum(len(chunk) for chunk in eng) == N_SHARDS * PER_SHARD
    assert _settle_threads(before) == []


def test_reader_exception_reaches_the_consumer(corpus):
    def bad_read(path):
        if "00002" in path:
            raise IOError(f"corrupt shard {path}")
        return read_shard(path)
    tasks = [(p, None) for p in ShardFolder.paths(corpus)]
    before = set(threading.enumerate())
    eng = IngestEngine(tasks, bad_read, config=IngestConfig(
        workers=2, chunk_records=4, device_put=False))
    with pytest.raises(IOError, match="corrupt shard"):
        for _ in eng:
            pass
    assert eng.closed and _settle_threads(before) == []


def test_stalls_are_charged_by_stage(corpus):
    prev = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)

    def slow_read(path):
        time.sleep(0.05)
        return read_shard(path)
    try:
        tasks = [(p, None) for p in ShardFolder.paths(corpus)]
        with IngestEngine(tasks, slow_read, config=IngestConfig(
                workers=1, chunk_records=PER_SHARD,
                device_put=False)) as eng:
            assert sum(len(c) for c in eng) == N_SHARDS * PER_SHARD
    finally:
        set_registry(prev)
    tm = instruments(reg)
    stalls = {lv[0]: c.value
              for lv, c in tm.ingest_stall_seconds_total.children()}
    assert stalls.get("step", 0) > 0
    assert tm.ingest_records_total.value == N_SHARDS * PER_SHARD
    assert tm.ingest_stage_seconds.labels(stage="read").snapshot()[
        "count"] == N_SHARDS


def test_validate_chain_refuses_what_the_pool_cannot_order():
    from bigdl_tpu_torch.dataset.base import Transformer

    class Stochastic(Transformer):
        stochastic = True

        def __call__(self, it):
            return it
    with pytest.raises(ValueError, match="stochastic"):
        validate_chain(Stochastic())
    dec = _decoder(NativeBGRBatchDecoder, True)
    with pytest.raises(ValueError, match="trailing position"):
        validate_chain(dec >> _decoder(NativeBGRBatchDecoder, True))
    assert validate_chain(dec) == ([], dec)


class _Drained(PrefetchingDataSet):
    drained = 0

    def drain(self):
        type(self).drained += 1
        super().drain()


def _classifier_opt(corpus, ckpt):
    model = (nn.Sequential()
             .add(nn.InputNormalize((127.5,) * 3, (73.0,) * 3))
             .add(nn.Reshape([REC])).add(nn.Linear(REC, 3))
             .add(nn.LogSoftMax()))
    ds = _Drained(ShardFolder.paths(corpus),
                  _decoder(NativeBGRBatchDecoder, False),
                  IngestConfig(workers=2, device="cpu"))
    return (Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
            .set_optim_method(SGD(learningrate=0.01))
            .set_end_when(Trigger.max_epoch(2))
            .set_checkpoint(str(ckpt), Trigger.every_epoch()))


def test_optimizer_trains_from_the_engine_and_drains_on_preemption(
        corpus, tmp_path):
    before = set(threading.enumerate())
    opt = _classifier_opt(corpus, tmp_path / "a")
    opt.optimize()
    assert len(opt.history) == 2 * (N_SHARDS * PER_SHARD // 4)
    assert np.isfinite([h["loss"] for h in opt.history]).all()
    assert _settle_threads(before) == []   # each epoch's engine closed
    _Drained.drained = 0
    opt = _classifier_opt(corpus, tmp_path / "b")
    opt.set_preemption_handler(PreemptionHandler(signals=(signal.SIGTERM,)))
    opt.set_chaos([KillAtStep(5)])
    with pytest.raises(TrainingPreempted):
        opt.optimize()
    assert _Drained.drained == 1
    assert _settle_threads(before) == []
