"""Synthetic-data throughput harness (counterpart of
``bigdl_tpu/apps/perf.py``, BigDL's ``DistriOptimizerPerf`` /
``LocalOptimizerPerf`` mains): trains one zoo model through ``Optimizer``
on random data and prints one JSON line of records a second.

    python -m bigdl_tpu_torch.apps.perf --model vit_s16 -b 256 -i 20
    python -m bigdl_tpu_torch.apps.perf --model transformer_1b -b 8 \\
        --optim adamw --optStateDtype bf16 --remat block --memStats
    python -m bigdl_tpu_torch.apps.perf --model lenet5 -b 4 -i 2 --device cpu

The flags, the models and the JSON line (``harness``, ``model``,
``batch``, ``iterations``, ``wall_s``, ``records_per_sec``,
``records_per_sec_incl_compile``, ``devices``, ``distributed``,
``precision``) are the reference's. The steady rate comes from the
per-iteration ``Throughput`` after ``max(warmup, 2k)`` iterations (a
k-step window spreads its time over its k iterations, so the first,
capture-bearing window is left out whole), as the records of those
iterations over their seconds. The reference averages the rates instead;
but an iteration's time is the interval between two loss fetches, and
where the host, not the device, sets the pace, the fetch after an epoch's
last dispatch splits two iterations' time into nearly all and nearly
nothing, and the mean of the rates runs away (533,463 records/s read for
ViT-S/16 at k = 1, whose iterations took 93 ms apiece, on an H100).

The data is ``np.random.RandomState(0)``'s, as in the reference; by
default it is cached on the device once (``DeviceCachedDataSet``, bf16
features under ``--precision bf16``); ``--no-device-cache`` collates and
copies every batch from the host instead.

The port's additions: ``--device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain versions), ``--records`` (the dataset's size, by default
the reference's ``batch * max(2, k)``; runs at several k over the same
batches give it one value), and ``--memStats`` reading ``torch.cuda``'s
allocator under the reference's four keys. The weights are drawn from
seed 0 and the shuffle stream restarts from seed 0, so that two runs in
one process see the same weights and batches. ``--moeExperts N`` gives a
transformer model a top-2 routed mixture of N experts in every block,
dispatched as ``--moeDispatch`` says (``scatter``, the default, or
``einsum``), as the reference's.

``--distributed`` trains data-parallel (``DistriOptimizer``, allreduce)
over the process group that the reference's environment names
(``BIGDL_COORDINATOR_ADDRESS``, ``BIGDL_NUM_PROCESSES``,
``BIGDL_PROCESS_ID``; without it, this process alone): ``-b`` is the
global batch and must divide by the world size, each rank keeps its slice
of the records, ``--backend`` picks the group's backend (``gloo`` for
ranks sharing one card), and the line's rates count every rank's records.
Each rank prints its line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

_LSTM_VOCAB = 20_000
_TRANSFORMER_VOCAB = 32_000


def _build_model(name: str, device, fused_head: bool = True,
                 moe_experts: int = 0, moe_dispatch: str = "scatter"):
    """(model, feature_shape, n_classes, int_vocab, seq_labels), as the
    reference's ``_build_model``: ``int_vocab > 0`` marks 1-based token
    features, ``seq_labels`` per-timestep targets (the causal LMs);
    ``moe_experts``: every block's FFN a routed MoE (transformer models)
    with ``moe_dispatch``."""
    from bigdl_tpu_torch.models import (inception, lenet, resnet, rnn,
                                        transformer, vgg, vit)
    kw = dict(device=device, seed=0)
    img = (224, 224, 3)

    def lm(*args, **options):
        if moe_experts:
            options["moe_experts"] = moe_experts
        return transformer.build_lm(_TRANSFORMER_VOCAB, *args,
                                    fused_head=fused_head, **options, **kw)

    llama = dict(num_kv_heads=8, rope=True, activation="swiglu", norm="rms",
                 tie_embeddings=True)
    builders = {
        "inception_v1": lambda: (inception.build(1000, **kw), img, 1000, 0,
                                 False),
        "inception_v2": lambda: (inception.build_v2(1000, **kw), img, 1000,
                                 0, False),
        "vgg16": lambda: (vgg.build_imagenet(1000, 16, **kw), img, 1000, 0,
                          False),
        "vgg19": lambda: (vgg.build_imagenet(1000, 19, **kw), img, 1000, 0,
                          False),
        "resnet50": lambda: (resnet.build(1000, 50, **kw), img, 1000, 0,
                             False),
        "lenet5": lambda: (lenet.build(10, **kw), (28, 28, 1), 10, 0, False),
        "vit_s16": lambda: (vit.build(1000, **kw), img, 1000, 0, False),
        "lstm": lambda: (rnn.build_classifier(_LSTM_VOCAB, 128, 128, 20,
                                              **kw),
                         (500,), 20, _LSTM_VOCAB, False),
        "transformer": lambda: (lm(256, 8, 1024, num_layers=4, max_len=2048),
                                (512,), _TRANSFORMER_VOCAB,
                                _TRANSFORMER_VOCAB, True),
        "transformer_134m": lambda: (lm(768, 12, 3072, num_layers=12,
                                        max_len=1024),
                                     (1024,), _TRANSFORMER_VOCAB,
                                     _TRANSFORMER_VOCAB, True),
        "transformer_368m": lambda: (lm(1024, 16, 4096, num_layers=24,
                                        max_len=1024),
                                     (1024,), _TRANSFORMER_VOCAB,
                                     _TRANSFORMER_VOCAB, True),
        # the reference's one-chip capacity configs (Llama recipe, S=2048):
        # run with --optim adamw --optStateDtype bf16 --remat block
        "transformer_830m": lambda: (lm(2048, 16, 5632, num_layers=16,
                                        max_len=2048, **llama),
                                     (2048,), _TRANSFORMER_VOCAB,
                                     _TRANSFORMER_VOCAB, True),
        "transformer_1b": lambda: (lm(2048, 16, 5632, num_layers=20,
                                      max_len=2048, **llama),
                                   (2048,), _TRANSFORMER_VOCAB,
                                   _TRANSFORMER_VOCAB, True),
    }
    if name not in builders:
        raise SystemExit(f"unknown model {name}; one of {sorted(builders)}")
    if moe_experts and not name.startswith("transformer"):
        raise SystemExit("--moeExperts applies to transformer models")
    out = builders[name]()
    if moe_experts:
        from bigdl_tpu_torch.parallel.expert import MoE
        for m in out[0].modules():
            if isinstance(m, MoE):
                m.dispatch = moe_dispatch
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bigdl_tpu_torch.apps.perf")
    ap.add_argument("--model", "-m", default="inception_v1")
    ap.add_argument("--batchSize", "-b", type=int, default=32)
    ap.add_argument("--iteration", "-i", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--dataType", choices=("constant", "random"),
                    default="random")
    ap.add_argument("--precision", choices=("fp32", "bf16"), default="bf16")
    ap.add_argument("--distributed", action="store_true",
                    help="data parallel over the BIGDL_* process group")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="--distributed: the group's backend (default nccl "
                    "on cards, gloo on the CPU)")
    ap.add_argument("--stepsPerDispatch", "-k", type=int, default=1,
                    help="k iterations a dispatch (set_steps_per_dispatch)")
    ap.add_argument("--optim", choices=("sgd", "adamw"), default="sgd",
                    help="adamw: the transformer-LM optimizer (lr 1e-4)")
    ap.add_argument("--optStateDtype", choices=("fp32", "bf16"),
                    default="fp32",
                    help="adamw only: the moments' storage dtype")
    ap.add_argument("--remat", choices=("none", "full", "conv", "block"),
                    default="none", help="activation recomputation policy")
    ap.add_argument("--memStats", action="store_true",
                    help="print the device allocator's statistics after "
                    "the run")
    ap.add_argument("--moeExperts", type=int, default=0,
                    help="transformer models: a top-2 routed MoE FFN with "
                    "this many experts (gelu models only)")
    ap.add_argument("--moeDispatch", choices=("scatter", "einsum"),
                    default="scatter",
                    help="MoE token dispatch: ragged scatter (default) or "
                    "dense GShard einsum masks")
    ap.add_argument("--no-fused-head", action="store_true",
                    help="LM only: TimeDistributed(Linear) + LogSoftMax and "
                    "ClassNLL instead of LMHead + FusedLMHeadCriterion")
    ap.add_argument("--no-device-cache", action="store_true",
                    help="collate and copy every batch from the host")
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default) or cpu")
    ap.add_argument("--records", type=int, default=0,
                    help="records of synthetic data (default: "
                    "batch * max(2, k))")
    return ap


def memory_stats(device: torch.device) -> dict:
    """The reference's ``memory_stats`` keys from PyTorch's allocator:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (allocated bytes, now and
    at peak), ``bytes_limit`` (the device's memory) and
    ``largest_alloc_size`` (the largest segment reserved). Empty on the
    CPU."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    segments = [s["total_size"] for s in torch.cuda.memory_snapshot()
                if s.get("device", device.index) == device.index]
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory,
            "largest_alloc_size": max(segments, default=0)}


class _Recorder:
    """A train-summary sink keeping each iteration's ``Throughput``, so
    that the steady rate can leave the warm-up out."""

    def __init__(self):
        self.throughputs: List[float] = []

    def add_scalar(self, tag, value, step):
        if tag == "Throughput":
            self.throughputs.append(float(value))

    def get_summary_trigger(self, name):
        return None


def run(argv: Optional[List[str]] = None) -> Tuple[dict, object]:
    """Parse ``argv``, train, and return (the JSON line's dict, the
    ``Optimizer``, whose ``history`` holds the losses)."""
    args = parser().parse_args(argv)
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset.base import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.dataset.device_cache import DeviceCachedDataSet
    from bigdl_tpu_torch.ops.precision import DtypePolicy
    from bigdl_tpu_torch.optim import SGD, AdamW, Optimizer, Trigger
    from bigdl_tpu_torch.utils.device import resolve_device
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.rng import RandomGenerator

    world = 1
    if args.distributed:
        if Engine.process_group_up() or not os.environ.get(
                "BIGDL_COORDINATOR_ADDRESS"):
            world = Engine.process_count()
        else:
            Engine.init_distributed(
                device=None if args.device == "cuda" else args.device,
                backend=args.backend)
            world = Engine.process_count()
        if args.batchSize % world:
            raise SystemExit(f"perf --distributed: batch {args.batchSize} "
                             f"does not divide by {world} processes")
    dev = resolve_device(args.device)
    model, shape, n_class, int_vocab, seq_labels = _build_model(
        args.model, dev, fused_head=not args.no_fused_head,
        moe_experts=args.moeExperts, moe_dispatch=args.moeDispatch)

    rng = np.random.RandomState(0)
    # enough records that a k-step window fits inside one epoch (epoch
    # boundaries bound dispatch windows)
    n_records = args.records or args.batchSize * max(2, args.stepsPerDispatch)
    if args.dataType == "constant":
        feats = [np.ones(shape, np.float32) for _ in range(n_records)]
    elif int_vocab:  # 1-based token indices (LookupTable input)
        feats = [rng.randint(1, int_vocab + 1, shape).astype(np.float32)
                 for _ in range(n_records)]
    else:
        feats = [rng.randn(*shape).astype(np.float32)
                 for _ in range(n_records)]
    if seq_labels:  # per-timestep targets (causal LM next-token loss)
        samples = [Sample(f, rng.randint(1, n_class + 1,
                                         shape).astype(np.float32))
                   for f in feats]
    else:
        samples = [Sample(f, np.float32(rng.randint(1, n_class + 1)))
                   for f in feats]
    del feats
    RandomGenerator.RNG().set_seed(0)
    # --distributed: each rank keeps its slice; the cache's batch is global
    if args.no_device_cache:
        ds = DataSet.array(samples, distributed=args.distributed,
                           seed=0).transform(
            SampleToBatch(batch_size=args.batchSize // world))
    else:
        ds = DeviceCachedDataSet(
            DataSet.array(samples, distributed=args.distributed),
            batch_size=args.batchSize,
            cast_dtype=("bfloat16" if args.precision == "bf16"
                        and not int_vocab else None), device=dev)

    if seq_labels:
        criterion = (nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
                     if args.no_fused_head else nn.FusedLMHeadCriterion())
    else:
        criterion = nn.ClassNLLCriterion()
    # a distributed dataset makes this a DistriOptimizer (allreduce)
    opt = Optimizer(model, ds, criterion, device=dev)
    if args.optim == "adamw":
        opt.set_optim_method(AdamW(
            learningrate=1e-4,
            state_dtype="bfloat16" if args.optStateDtype == "bf16" else None))
    else:
        opt.set_optim_method(SGD(learningrate=0.01))
    if args.remat != "none":
        opt.set_remat(True if args.remat == "full" else args.remat)
    if args.stepsPerDispatch > 1:
        opt.set_steps_per_dispatch(args.stepsPerDispatch)
    if args.precision == "bf16":
        opt.set_precision(DtypePolicy.bf16())
    total_iters = args.warmup + args.iteration
    recorder = _Recorder()
    opt.set_train_summary(recorder)
    opt.set_end_when(Trigger.max_iteration(total_iters))

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    opt.optimize()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    if args.memStats:
        # stderr, as the reference writes it: stdout holds one result line
        print(json.dumps({"memory_stats": memory_stats(dev)}),
              file=sys.stderr, flush=True)
    # a k-step window spreads its time over its k entries: the first
    # (capture-bearing) window must be left out whole
    warmup_eff = max(args.warmup, 2 * args.stepsPerDispatch)
    steady = recorder.throughputs[warmup_eff:]
    # equal batches: their records over their seconds is the harmonic mean
    rate = len(steady) / sum(1.0 / t for t in steady) if steady else 0.0
    result = {
        "harness": "perf", "model": args.model, "batch": args.batchSize,
        "iterations": args.iteration, "wall_s": round(wall, 3),
        "records_per_sec": round(float(rate), 1),
        "records_per_sec_incl_compile":
            round(total_iters * args.batchSize / wall, 1),
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "distributed": bool(args.distributed),
        "precision": args.precision,
    }
    return result, opt


def main(argv: Optional[List[str]] = None) -> dict:
    result, _ = run(argv)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
