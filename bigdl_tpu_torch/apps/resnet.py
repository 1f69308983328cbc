"""ResNet on CIFAR-10, train and test (counterpart of
``bigdl_tpu/apps/resnet.py``):

    python -m bigdl_tpu_torch.apps.resnet train [-f CIFAR_DIR] [--depth 20]
        [--shortcutType A|B] [--[no-]nesterov] [-b 128] [-e 165] [-r 0.1]
        [--device cuda|cpu]
    python -m bigdl_tpu_torch.apps.resnet test --model DIR/model_final

The reference's recipe: ``resnet.build_cifar``, ``CrossEntropyCriterion``,
SGD with momentum (nesterov by default, dampening 0), weight decay 1e-4
and the ``Regime`` schedule (epochs 1-80 at the rate, 81-120 at a tenth,
121 on at a hundredth); CIFAR-10's channel statistics, flips and padded
crops, batches prefetched on a host thread.
"""

from __future__ import annotations

import argparse
import sys

from bigdl_tpu_torch.apps.common import (build_optimizer, run_test,
                                         test_parser, train_parser)
from bigdl_tpu_torch.dataset import cifar
from bigdl_tpu_torch.dataset.base import DataSet, Prefetch
from bigdl_tpu_torch.dataset.image import (BGRImgNormalizer, BGRImgRdmCropper,
                                           BGRImgToBatch, HFlip)
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD, EpochSchedule, Regime, Top1Accuracy
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.table import T

MEAN, STD = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)


def _train_set(folder, batch, synthetic_size):
    imgs = (cifar.load_dir(folder, train=True) if folder
            else cifar.synthetic(synthetic_size))
    return (DataSet.array(imgs) >> BGRImgNormalizer(MEAN, STD)
            >> HFlip(0.5) >> BGRImgRdmCropper(32, 32, padding=4)
            >> BGRImgToBatch(batch) >> Prefetch(2))


def _val_set(folder, batch, synthetic_size):
    imgs = (cifar.load_dir(folder, train=False) if folder
            else cifar.synthetic(synthetic_size))
    return (DataSet.array(imgs) >> BGRImgNormalizer(MEAN, STD)
            >> BGRImgToBatch(batch))


def train(argv):
    """Trains and returns the model."""
    parser = train_parser("bigdl_tpu_torch.apps.resnet train",
                          default_epochs=165, default_lr=0.1)
    parser.add_argument("--depth", type=int, default=20)
    parser.add_argument("--shortcutType", default="A", choices=("A", "B"))
    parser.add_argument("--nesterov", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.set_defaults(weightDecay=1e-4)
    args = parser.parse_args(argv)
    model = resnet.build_cifar(10, depth=args.depth,
                               shortcut_type=args.shortcutType,
                               device=args.device)
    lr = args.learningRate
    opt = build_optimizer(
        model, _train_set(args.folder, args.batchSize, args.synthetic_size),
        CrossEntropyCriterion(), args,
        validation_set=_val_set(args.folder, args.batchSize,
                                args.synthetic_size),
        methods=[Top1Accuracy()],
        optim_method=SGD(
            learningrate=lr, momentum=args.momentum,
            dampening=0.0 if args.nesterov else args.momentum,
            nesterov=args.nesterov, weightdecay=args.weightDecay,
            learningrate_schedule=EpochSchedule([
                Regime(1, 80, T(learningRate=lr)),
                Regime(81, 120, T(learningRate=lr / 10)),
                Regime(121, 100000, T(learningRate=lr / 100))])))
    trained = opt.optimize()
    if args.checkpoint:
        file_io.save(trained, file_io.join(args.checkpoint, "model_final"))
    return trained


def test(argv) -> list:
    parser = test_parser("bigdl_tpu_torch.apps.resnet test")
    parser.add_argument("--depth", type=int, default=20)
    args = parser.parse_args(argv)
    return run_test(args.model,
                    _val_set(args.folder, args.batchSize, args.synthetic_size),
                    [Top1Accuracy()], args.device)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("train", "test"):
        raise SystemExit("usage: python -m bigdl_tpu_torch.apps.resnet "
                         "{train|test} ...")
    (train if argv[0] == "train" else test)(argv[1:])


if __name__ == "__main__":
    main()
