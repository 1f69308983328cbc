"""Shared CLI plumbing of the app mains (counterpart of
``bigdl_tpu/apps/common.py``: ``train_parser``, ``test_parser``,
``build_optimizer`` and ``run_test``).

The options are the reference's: ``--model``/``--state`` resume from a
snapshot pair, ``--checkpoint`` writes one every epoch
(``--overWriteCheckpoint`` keeps only the last), ``--autoResume``
continues from the newest complete one, ``--preemptSnapshot`` snapshots on
a SIGTERM and exits, ``--summary DIR`` writes TensorBoard summaries
(``TrainSummary`` / ``ValidationSummary`` under ``DIR/<appName>/``).
``--device`` (default ``cuda``) is the port's device rule: the card unless
the CPU is asked for.
"""

from __future__ import annotations

import argparse
import logging

from bigdl_tpu_torch.optim import (SGD, Loss, Optimizer, Top1Accuracy,
                                   Top5Accuracy, Trigger)
from bigdl_tpu_torch.utils.logger_filter import redirect_logs


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


def test_parser(prog: str, default_batch: int = 128) -> argparse.ArgumentParser:
    """The reference's test option set, plus ``--device``."""
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("-f", "--folder", default=None)
    p.add_argument("--model", required=True, help="trained model snapshot")
    p.add_argument("-b", "--batchSize", type=int, default=default_batch)
    p.add_argument("--synthetic-size", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="where to evaluate: cuda (default) or cpu")
    return p


def build_optimizer(model, train_set, criterion, args, validation_set=None,
                    methods=None, optim_method=None,
                    topology=None) -> Optimizer:
    """The per-model ``Train.scala`` body (reference ``build_optimizer``):
    optimizer, SGD from the parsed rates, the epoch end trigger, the
    gradient clippers, resume, checkpoints, preemption, summaries and,
    with a validation set, per-epoch validation, on ``args.device``. The
    summaries' event files are closed (every event flushed) when the
    program exits. The logs are routed by ``redirect_logs``. ``topology``:
    a ``parallel.MeshTopology`` for ``DistriOptimizer``."""
    redirect_logs()
    extra = {} if topology is None else {"topology": topology}
    opt = Optimizer(model, train_set, criterion, device=args.device, **extra)
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
    if args.model and args.state:
        opt.resume(args.model, args.state)
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        if args.overWriteCheckpoint:
            opt.overwrite_checkpoint()
    if getattr(args, "autoResume", False):
        opt.auto_resume()
    if getattr(args, "preemptSnapshot", False):
        opt.set_preemption_handler()
    if validation_set is not None:
        opt.set_validation(Trigger.every_epoch(), validation_set,
                           methods or [Top1Accuracy(), Top5Accuracy(),
                                       Loss()])
    if args.summary:
        import atexit

        from bigdl_tpu_torch.visualization import (TrainSummary,
                                                   ValidationSummary)
        train_summary = TrainSummary(args.summary, args.appName)
        validation_summary = ValidationSummary(args.summary, args.appName)
        opt.set_train_summary(train_summary)
        opt.set_validation_summary(validation_summary)
        atexit.register(train_summary.close)
        atexit.register(validation_summary.close)
    return opt


def run_test(model_path: str, test_set, methods, device="cuda") -> list:
    """The per-model ``Test.scala`` body: a saved module, evaluated;
    prints and returns ``[(result, method)]``."""
    redirect_logs()
    from bigdl_tpu_torch.utils import file_io
    model = file_io.load(model_path, device=device)
    if isinstance(model, dict) and "params" in model:
        raise SystemExit(
            "got a checkpoint dict; pass it through the owning model: "
            "use train --model/--state to resume, or save the module itself")
    results = model.evaluate(test_set, methods)
    for result, method in results:
        logging.getLogger("bigdl_tpu_torch.optim").info(
            "%s is %s", method.name, result)
        print(f"{method.name}: {result}")
    return results
