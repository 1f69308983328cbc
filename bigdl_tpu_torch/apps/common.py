"""Shared CLI plumbing of the app mains (counterpart of
``bigdl_tpu/apps/common.py``: ``train_parser`` and ``build_optimizer``).

The options are the reference's. Those whose machinery is not ported yet
stop the program with a message naming the ROADMAP item that will port
them: snapshots (``--model``, ``--state``, ``--checkpoint``,
``--autoResume``, ``--preemptSnapshot``: A.5) and TensorBoard summaries
(``--summary``: A.6). ``--device`` (default ``cuda``) is the port's device
rule: the card unless the CPU is asked for.
"""

from __future__ import annotations

import argparse

from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

#: option attribute -> the ROADMAP item that will port it
WAITING = {
    "model": "A.5 (checkpoint and resume)",
    "state": "A.5 (checkpoint and resume)",
    "checkpoint": "A.5 (checkpoint and resume)",
    "autoResume": "A.5 (checkpoint and resume)",
    "preemptSnapshot": "A.5 (resilience: preemption snapshots)",
    "summary": "A.6 (visualization: TrainSummary / ValidationSummary)",
}


def train_parser(prog: str, default_batch: int = 128,
                 default_epochs: int = 5,
                 default_lr: float = 0.01) -> argparse.ArgumentParser:
    """The reference's train option set, plus ``--device``."""
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("-f", "--folder", default=None,
                   help="dataset location (synthetic data when omitted)")
    p.add_argument("-b", "--batchSize", type=int, default=default_batch)
    p.add_argument("-e", "--maxEpoch", type=int, default=default_epochs)
    p.add_argument("-r", "--learningRate", type=float, default=default_lr)
    p.add_argument("--learningRateDecay", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weightDecay", type=float, default=0.0)
    p.add_argument("--model", default=None, help="model snapshot to resume")
    p.add_argument("--state", default=None, help="state snapshot to resume")
    p.add_argument("--checkpoint", default=None,
                   help="where to write model/state snapshots")
    p.add_argument("--overWriteCheckpoint", action="store_true")
    p.add_argument("--summary", default=None,
                   help="TensorBoard log dir (TrainSummary/ValidationSummary)")
    p.add_argument("--appName", default=prog)
    p.add_argument("--synthetic-size", type=int, default=2048,
                   help="records of synthetic data when no -f")
    p.add_argument("--gradientClipL2Norm", type=float, default=0.0,
                   help="clip gradients to this global L2 norm (0 = off)")
    p.add_argument("--gradientClipConstant", type=float, nargs=2,
                   default=None, metavar=("MIN", "MAX"),
                   help="clamp every gradient element into [MIN, MAX]")
    p.add_argument("--autoResume", action="store_true",
                   help="continue from the newest complete snapshot under "
                   "--checkpoint")
    p.add_argument("--preemptSnapshot", action="store_true",
                   help="snapshot on a preemption notice, then exit")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    return p


def refuse_waiting(args) -> None:
    """Stop with a message naming the ROADMAP item of the first option set
    whose machinery the port does not have yet."""
    for name, item in WAITING.items():
        if getattr(args, name, None):
            raise SystemExit(f"--{name} is not ported yet: ROADMAP {item}")


def build_optimizer(model, train_set, criterion, args,
                    optim_method=None) -> Optimizer:
    """The per-model ``Train.scala`` body (reference ``build_optimizer``):
    optimizer, SGD from the parsed rates, the epoch end trigger and the
    gradient clippers, on ``args.device``."""
    refuse_waiting(args)
    opt = Optimizer(model, train_set, criterion, device=args.device)
    opt.set_optim_method(optim_method or SGD(
        learningrate=args.learningRate,
        learningrate_decay=args.learningRateDecay,
        momentum=args.momentum,
        weightdecay=args.weightDecay))
    opt.set_end_when(Trigger.max_epoch(args.maxEpoch))
    if getattr(args, "gradientClipL2Norm", 0.0):
        opt.set_gradient_clipping_by_l2_norm(args.gradientClipL2Norm)
    if getattr(args, "gradientClipConstant", None):
        opt.set_constant_gradient_clipping(*args.gradientClipConstant)
    return opt
