"""VGG on CIFAR-10, train and test (counterpart of
``bigdl_tpu/apps/vgg.py``):

    python -m bigdl_tpu_torch.apps.vgg train [-f CIFAR_DIR] [-b 128]
        [-e 5] [-r 0.01] [--checkpoint DIR] [--device cuda|cpu]
    python -m bigdl_tpu_torch.apps.vgg test --model DIR/model_final

Without ``-f`` the data is ``cifar.synthetic``. Training normalises with
CIFAR-10's channel statistics, flips half the images and crops 32x32 out
of a 4-pixel zero border (the reference's augmentations); ``build`` reads
``BIGDL_TPU_FUSED_3X3`` (K6 on the card).
"""

from __future__ import annotations

import sys

from bigdl_tpu_torch.apps.common import (build_optimizer, run_test,
                                         test_parser, train_parser)
from bigdl_tpu_torch.dataset import cifar
from bigdl_tpu_torch.dataset.base import DataSet
from bigdl_tpu_torch.dataset.image import (BGRImgNormalizer, BGRImgRdmCropper,
                                           BGRImgToBatch, HFlip)
from bigdl_tpu_torch.models import vgg
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.optim import Top1Accuracy
from bigdl_tpu_torch.utils import file_io

MEAN, STD = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)


def _train_set(folder, batch, synthetic_size):
    imgs = (cifar.load_dir(folder, train=True) if folder
            else cifar.synthetic(synthetic_size))
    return (DataSet.array(imgs)
            >> BGRImgNormalizer(MEAN, STD)
            >> HFlip(0.5)
            >> BGRImgRdmCropper(32, 32, padding=4)
            >> BGRImgToBatch(batch))


def _val_set(folder, batch, synthetic_size):
    imgs = (cifar.load_dir(folder, train=False) if folder
            else cifar.synthetic(synthetic_size))
    return (DataSet.array(imgs) >> BGRImgNormalizer(MEAN, STD)
            >> BGRImgToBatch(batch))


def train(argv):
    """Trains and returns the model."""
    args = train_parser("bigdl_tpu_torch.apps.vgg train",
                        default_lr=0.01).parse_args(argv)
    opt = build_optimizer(
        vgg.build(10, device=args.device),
        _train_set(args.folder, args.batchSize, args.synthetic_size),
        ClassNLLCriterion(), args,
        validation_set=_val_set(args.folder, args.batchSize,
                                args.synthetic_size))
    trained = opt.optimize()
    if args.checkpoint:
        file_io.save(trained, file_io.join(args.checkpoint, "model_final"))
    return trained


def test(argv) -> list:
    args = test_parser("bigdl_tpu_torch.apps.vgg test").parse_args(argv)
    return run_test(args.model,
                    _val_set(args.folder, args.batchSize, args.synthetic_size),
                    [Top1Accuracy()], args.device)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("train", "test"):
        raise SystemExit("usage: python -m bigdl_tpu_torch.apps.vgg "
                         "{train|test} ...")
    (train if argv[0] == "train" else test)(argv[1:])


if __name__ == "__main__":
    main()
