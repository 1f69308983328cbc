"""Sustained shard-ingest benchmark (counterpart of
``bigdl_tpu/apps/ingest_bench.py``): the ImageNet-scale host data path
measured stage by stage, so the binding bottleneck gets a name::

    # one-time: a synthetic raw-BGR corpus, shard files on disk
    python -m bigdl_tpu_torch.apps.ingest_bench generate -o SHARDS -n 4096
    # raw shard read (disk + CRC framing walk), no decode
    python -m bigdl_tpu_torch.apps.ingest_bench read -s SHARDS
    # + decode/normalize/collate through the host pipeline
    python -m bigdl_tpu_torch.apps.ingest_bench decode -s SHARDS -w 4
    # end to end: shards feeding the ResNet-50 training loop
    python -m bigdl_tpu_torch.apps.ingest_bench train -s SHARDS \\
        --deviceNormalize [--engine pipelined]
    # serial against staged engine (dataset/ingest/), artifact + trace
    python -m bigdl_tpu_torch.apps.ingest_bench pipeline -s SHARDS \\
        --workers 2 --prefetch-depth 2 --engine both \\
        --jsonOut ingest.json --traceOut ingest_trace.json

Each mode prints one JSON line with the reference's keys (records/s, ...).
``--device`` (default ``cuda``) is where batches land and the model
trains; ``cpu`` on request. ``train`` builds ResNet-50 (1000 classes)
under the bf16 policy with SGD 0.01; ``BIGDL_TPU_FUSED_1X1=1`` and
``BIGDL_TPU_FUSED_3X3=1`` select the fused conv+BN modules (kernels K5 and
K6 on the card). Its data are the reference's chain (``ShardFolder.stream
>> decoder >> Prefetch``), or with ``--engine pipelined`` the staged
engine (``PrefetchingDataSet``, batches copied to the card by its feed).
``optimizer(argv)`` returns that run's ``Optimizer`` before it starts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

IMG_BYTES = 224 * 224 * 3
#: the least seconds each serial stage is measured for in ``pipeline``
#: (the reference's floor)
STAGE_BUDGET_FLOOR_S = 5.0


def _gen(args) -> None:
    from bigdl_tpu_torch.dataset.shards import ShardWriter
    rng = np.random.RandomState(7)
    t0 = time.time()
    with ShardWriter(f"{args.out}/part", records_per_shard=args.perShard) as w:
        for i in range(args.records):
            w.write(float(i % 1000 + 1),
                    rng.randint(0, 256, IMG_BYTES, np.uint8).tobytes())
    print(json.dumps({"mode": "generate", "records": args.records,
                      "bytes": args.records * IMG_BYTES,
                      "wall_s": round(time.time() - t0, 1)}))


def _pipeline(args):
    """Full host path: stream -> decode/normalize -> collate -> prefetch.

    ``--native`` (default): the whole-batch threaded C++ decode
    (``NativeBGRBatchDecoder``); ``--no-native``: the per-record MT
    pipeline, kept as the A/B baseline."""
    from bigdl_tpu_torch.dataset.base import Prefetch
    from bigdl_tpu_torch.dataset.shards import ShardFolder
    if args.native:
        from bigdl_tpu_torch.dataset.image import NativeBGRBatchDecoder
        dec = NativeBGRBatchDecoder(
            224, 224, args.batchSize,
            mean=(127.5,) * 3, std=(73.0,) * 3, workers=args.workers,
            device_normalize=args.deviceNormalize)
    else:
        if args.deviceNormalize:
            raise SystemExit("--deviceNormalize requires the native batch "
                             "path (it ships raw uint8); drop --no-native "
                             "or the flag: combining them would normalize "
                             "twice")
        from bigdl_tpu_torch.dataset.image import (BGRImgNormalizer,
                                                   BytesToBGRImg,
                                                   MTLabeledBGRImgToBatch)
        dec = MTLabeledBGRImgToBatch(
            224, 224, args.batchSize,
            transformer=(BytesToBGRImg(224, 224)
                         >> BGRImgNormalizer(127.5, 73.0)),
            workers=args.workers)
    return ShardFolder.stream(args.shards) >> dec >> Prefetch(args.prefetch)


def _cycle(make_iter):
    """Endless stream over finite per-epoch iterators (empty datasets
    end it)."""
    while True:
        n = 0
        for item in make_iter():
            n += 1
            yield item
        if n == 0:
            return


def _measure_iter(make_iter, record_weight, warm: int, budget_s: float):
    """records/s over the steady state (after ``warm`` items), cycling
    epochs until the time budget is spent."""
    n = 0
    t0 = t_warm = time.time()
    for _ in _cycle(make_iter):
        n += 1
        if n == warm:
            t_warm = time.time()
        if time.time() - t0 > budget_s and n > warm:
            break
    steady = (n - warm) * record_weight
    dt = time.time() - t_warm
    return steady / dt if dt > 0 and steady > 0 else 0.0


def _read(args) -> None:
    from bigdl_tpu_torch.dataset.shards import ShardFolder
    ds = ShardFolder.stream(args.shards)
    warm = min(256, max(1, ds.size() // 4))
    rate = _measure_iter(lambda: ds.data(train=True), 1, warm=warm,
                         budget_s=args.budget)
    print(json.dumps({"mode": "read", "records_per_sec": round(rate, 1),
                      "gbytes_per_sec": round(rate * IMG_BYTES / 1e9, 3)}))


def _decode(args) -> None:
    ds = _pipeline(args)
    rate = _measure_iter(lambda: ds.data(train=True), args.batchSize,
                         warm=2, budget_s=args.budget)
    print(json.dumps({"mode": "decode", "workers": args.workers,
                      "records_per_sec": round(rate, 1)}))


def _decoder(args):
    """The engine path's decode/collate chain: the whole-batch C++ decode
    shipping raw uint8 (normalised on the device by the model)."""
    from bigdl_tpu_torch.dataset.image import NativeBGRBatchDecoder
    return NativeBGRBatchDecoder(
        224, 224, args.batchSize, mean=(127.5,) * 3, std=(73.0,) * 3,
        workers=args.workers, device_normalize=True)


def _engine_dataset(args, serial: bool):
    from bigdl_tpu_torch.dataset.ingest import (IngestConfig,
                                                PrefetchingDataSet)
    cfg = IngestConfig(workers=args.workers,
                       prefetch_depth=args.prefetchDepth, device=args.device)
    return PrefetchingDataSet.from_folder(
        args.shards, transformer=_decoder(args), config=cfg, serial=serial)


def _measure_engine(args, serial: bool) -> dict:
    """End-to-end records/s landing on the device at the consumer. The
    serial engine hands host batches over and the consumer pays the copy
    to the card itself; the pipelined engine's batches are there already
    (or in flight), and the consumer waits for them. A fresh metrics
    registry scopes the stage ledger to this one run."""
    import torch

    from bigdl_tpu_torch.telemetry import (MetricsRegistry, get_registry,
                                           instruments, set_registry, span)
    from bigdl_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    prev = get_registry()
    set_registry(MetricsRegistry())
    try:
        ds = _engine_dataset(args, serial=serial)
        warm, n = 2, 0
        t0 = t_warm = time.time()
        done = False
        while not done:
            it = iter(ds.data(train=True))
            got = 0
            for batch in it:
                got += 1
                with span("ingest.step", batch=n):
                    data, labels = batch.data, batch.labels
                    if serial:
                        data, labels = (
                            torch.as_tensor(a).pin_memory().to(
                                dev, non_blocking=True)
                            if dev.type == "cuda" else torch.as_tensor(a)
                            for a in (data, labels))
                    if dev.type == "cuda":
                        torch.cuda.current_stream(dev).synchronize()
                    if args.stepMs > 0:
                        # a stand-in for the device step: a wait that
                        # releases the interpreter, under which the
                        # pipeline can hide ingest
                        time.sleep(args.stepMs / 1e3)
                n += 1
                if n == warm:
                    t_warm = time.time()
                if time.time() - t0 > args.budget and n > warm:
                    done = True
                    break
            close = getattr(it, "close", None)
            if close is not None:
                close()
            if got == 0:
                break
        steady = (n - warm) * args.batchSize
        dt = time.time() - t_warm
        out = {"engine": "serial" if serial else "pipelined",
               "records_per_sec":
                   round(steady / dt, 1) if dt > 0 and steady > 0 else 0.0,
               "batches": n}
        if not serial:
            ins = instruments(get_registry())
            out["stage_seconds"] = {
                lv[0]: round(c.sum, 3)
                for lv, c in ins.ingest_stage_seconds.children()}
            out["stall_seconds"] = {
                lv[0]: round(c.value, 3)
                for lv, c in ins.ingest_stall_seconds_total.children()}
            out["records"] = int(ins.ingest_records_total.value)
    finally:
        set_registry(prev)
    return out


def _serial_stage_rates(args) -> dict:
    """Per-stage ceilings of the serial path (what modes ``read`` and
    ``decode`` measure), folded into the comparison artifact."""
    from bigdl_tpu_torch.dataset.shards import ShardFolder
    budget = max(STAGE_BUDGET_FLOOR_S, args.budget / 4)
    raw = ShardFolder.stream(args.shards)
    warm = min(256, max(1, raw.size() // 4))
    read_rate = _measure_iter(lambda: raw.data(train=True), 1, warm=warm,
                              budget_s=budget)
    dec = ShardFolder.stream(args.shards) >> _decoder(args)
    decode_rate = _measure_iter(lambda: dec.data(train=True),
                                args.batchSize, warm=2, budget_s=budget)
    return {"read_records_per_sec": round(read_rate, 1),
            "decode_records_per_sec": round(decode_rate, 1)}


def _pipeline_mode(args) -> None:
    from bigdl_tpu_torch.telemetry import tracing
    runs = {"serial": (True,), "pipelined": (False,),
            "both": (True, False)}[args.engine]
    out = {"bench": "ingest_r01", "schema": 1,
           "host_cores": os.cpu_count() or 1,
           "config": {"batch_size": args.batchSize, "workers": args.workers,
                      "prefetch_depth": args.prefetchDepth,
                      "device_normalize": True,
                      "step_ms": args.stepMs,
                      "budget_s": args.budget, "device": args.device}}
    for serial in runs:
        tracing_this = bool(args.traceOut) and not serial
        if tracing_this:
            tracing.clear()
            tracing.enable()
        res = _measure_engine(args, serial=serial)
        if tracing_this:
            tracing.disable()
            tracing.dump(args.traceOut)
        out[res.pop("engine")] = res
    if "serial" in out and args.engine in ("serial", "both"):
        out["serial"]["stages"] = _serial_stage_rates(args)
    if "serial" in out and "pipelined" in out:
        sp = (out["pipelined"]["records_per_sec"]
              / max(out["serial"]["records_per_sec"], 1e-9))
        out["speedup"] = round(sp, 2)
        if sp < 2.0:
            out["note"] = (
                f"measured on a {out['host_cores']}-core host: reader/"
                "decoder/feeder threads and the consumer share the cores, "
                "so overlap is limited to the windows that release the "
                "interpreter (file IO, native batch decode, the copy to the "
                "card); the stage ledger shows the per-stage wall-clock the "
                "pipeline hides when cores exist")
    blob = json.dumps(out, indent=2, sort_keys=True) + "\n"
    if args.jsonOut:
        with open(args.jsonOut, "w") as f:
            f.write(blob)
        print(json.dumps({"mode": "pipeline", "wrote": args.jsonOut,
                          "speedup": out.get("speedup"),
                          "trace": args.traceOut or None}))
    else:
        sys.stdout.write(blob)


class _Rates:
    """A train summary that keeps the per-iteration throughputs."""

    def __init__(self):
        self.rates = []

    def add_scalar(self, tag, value, step):
        if tag == "Throughput":
            self.rates.append(float(value))

    def get_summary_trigger(self, name):
        return None


def _train_dataset(args):
    if args.engine == "pipelined":
        from bigdl_tpu_torch.dataset.image import NativeBGRBatchDecoder
        from bigdl_tpu_torch.dataset.ingest import (IngestConfig,
                                                    PrefetchingDataSet)
        dec = NativeBGRBatchDecoder(
            224, 224, args.batchSize, mean=(127.5,) * 3, std=(73.0,) * 3,
            workers=args.workers, device_normalize=args.deviceNormalize)
        return PrefetchingDataSet.from_folder(
            args.shards, transformer=dec,
            config=IngestConfig(workers=args.workers,
                                prefetch_depth=args.prefetchDepth,
                                device=args.device))
    return _pipeline(args)


def optimizer(argv=None):
    """``train``'s run before it starts: ``(Optimizer, arguments)``."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.ops.precision import DtypePolicy
    from bigdl_tpu_torch.utils.logger_filter import redirect_logs
    args = _parser().parse_args(["train", *(argv or [])])
    redirect_logs()
    ds = _train_dataset(args)
    model = resnet.build(1000, depth=50, device=args.device)
    if args.deviceNormalize:
        # uint8 batches over the wire; cast and normalize on the device
        model = (nn.Sequential()
                 .add(nn.InputNormalize((127.5,) * 3, (73.0,) * 3))
                 .add(model))
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device=args.device)
    opt.set_optim_method(SGD(learningrate=0.01))
    opt.set_precision(DtypePolicy.bf16())
    opt.set_end_when(Trigger.max_iteration(args.iterations))
    if args.stepsPerDispatch > 1:
        opt.set_steps_per_dispatch(args.stepsPerDispatch)
    opt.set_train_summary(_Rates())
    return opt, args


def train_result(opt, args, wall_s: float) -> dict:
    """``train``'s JSON line from a finished run: the reference's keys and
    the steady iterations' median ms."""
    steady = opt.train_summary.rates[args.warmup:]
    secs = sorted(h["seconds"] for h in opt.history[args.warmup:])
    return {"mode": "train", "iterations": args.iterations,
            "records_per_sec": round(float(np.mean(steady)), 1)
            if steady else 0,
            "iteration_ms": round(secs[len(secs) // 2] * 1e3, 3)
            if secs else None,
            "wall_s": round(wall_s, 1)}


def _train(argv) -> None:
    opt, args = optimizer(argv)
    t0 = time.time()
    opt.optimize()
    print(json.dumps(train_result(opt, args, time.time() - t0)))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bigdl_tpu_torch.apps.ingest_bench")
    ap.add_argument("mode", choices=("generate", "read", "decode", "train",
                                     "pipeline"))
    ap.add_argument("--out", "-o", default="/tmp/bigdl_shards")
    ap.add_argument("--shards", "-s", default="/tmp/bigdl_shards")
    ap.add_argument("--records", "-n", type=int, default=4096)
    ap.add_argument("--perShard", type=int, default=512)
    ap.add_argument("--batchSize", "-b", type=int, default=256)
    ap.add_argument("--workers", "-w", type=int, default=4)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--prefetch-depth", "--prefetchDepth",
                    dest="prefetchDepth", type=int, default=2,
                    help="ready-batch queue depth between the device-feed "
                    "stage and the consumer (pipeline; train with "
                    "--engine pipelined)")
    ap.add_argument("--engine", choices=("serial", "pipelined", "both"),
                    default="both",
                    help="pipeline mode: which ingest engine(s) to measure; "
                    "train: 'pipelined' feeds from the staged engine, "
                    "otherwise the reference's serial chain")
    ap.add_argument("--step-ms", "--stepMs", dest="stepMs", type=float,
                    default=0.0,
                    help="pipeline mode: a simulated device step per batch "
                    "(a wait that releases the interpreter); 0 measures "
                    "the host ingest path alone")
    ap.add_argument("--jsonOut", default=None,
                    help="pipeline mode: write the comparison artifact "
                    "here instead of stdout")
    ap.add_argument("--traceOut", default=None,
                    help="pipeline mode: dump a Chrome trace of the "
                    "pipelined run's overlapping ingest.* spans here")
    ap.add_argument("--budget", type=float, default=60.0,
                    help="measurement budget (seconds) for read/decode/"
                    "pipeline")
    ap.add_argument("--native", dest="native", action="store_true",
                    default=True,
                    help="whole-batch C++ decode (default)")
    ap.add_argument("--no-native", dest="native", action="store_false",
                    help="per-record MT Python decode (A/B)")
    ap.add_argument("--deviceNormalize", action="store_true",
                    help="ship uint8 batches and normalize on the device "
                    "(nn.InputNormalize): 4x fewer bytes to the card")
    ap.add_argument("--iterations", "-i", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--stepsPerDispatch", "-k", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where batches land and the model trains (default "
                    "cuda; cpu on request)")
    return ap


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.mode == "train":
        argv.remove("train")        # optimizer() takes train's flags
        _train(argv)
        return
    {"generate": _gen, "read": _read, "decode": _decode,
     "pipeline": _pipeline_mode}[args.mode](args)


if __name__ == "__main__":
    main()
