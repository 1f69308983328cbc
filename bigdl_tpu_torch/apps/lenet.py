"""LeNet-5 on MNIST, train and test (counterpart of
``bigdl_tpu/apps/lenet.py``):

    python -m bigdl_tpu_torch.apps.lenet train [-f MNIST_DIR] [-b 128]
        [-e 5] [-r 0.05] [--checkpoint DIR] [--device cuda|cpu]
    python -m bigdl_tpu_torch.apps.lenet test --model DIR/model_final
        [-f MNIST_DIR]

Without ``-f`` the data is ``mnist.synthetic``. Images are normalised with
the reference's MNIST mean and standard deviation; training validates
every epoch on the test split; ``test`` prints and returns Top-1.
"""

from __future__ import annotations

import sys

from bigdl_tpu_torch.apps.common import (build_optimizer, run_test,
                                         test_parser, train_parser)
from bigdl_tpu_torch.dataset import mnist
from bigdl_tpu_torch.dataset.base import DataSet
from bigdl_tpu_torch.dataset.image import (BytesToGreyImg, GreyImgNormalizer,
                                           GreyImgToBatch)
from bigdl_tpu_torch.models import lenet
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.optim import Top1Accuracy
from bigdl_tpu_torch.utils import file_io

TRAIN_MEAN, TRAIN_STD = 0.13066047740239478 * 255, 0.3081078 * 255


def _dataset(folder, batch, train, synthetic_size):
    records = (mnist.load_dir(folder, train=train) if folder
               else mnist.synthetic(synthetic_size))
    return (DataSet.array(records) >> BytesToGreyImg(28, 28)
            >> GreyImgNormalizer(TRAIN_MEAN, TRAIN_STD)
            >> GreyImgToBatch(batch))


def train(argv):
    """Trains and returns the model (saved as ``model_final`` under
    ``--checkpoint``)."""
    args = train_parser("bigdl_tpu_torch.apps.lenet train",
                        default_lr=0.05).parse_args(argv)
    train_set = _dataset(args.folder, args.batchSize, True,
                         args.synthetic_size)
    val_set = _dataset(args.folder, args.batchSize, False,
                       args.synthetic_size)
    model = lenet.build(10, device=args.device)
    opt = build_optimizer(model, train_set, ClassNLLCriterion(), args,
                          validation_set=val_set)
    trained = opt.optimize()
    if args.checkpoint:
        file_io.save(trained, file_io.join(args.checkpoint, "model_final"))
    return trained


def test(argv) -> list:
    args = test_parser("bigdl_tpu_torch.apps.lenet test").parse_args(argv)
    test_set = _dataset(args.folder, args.batchSize, False,
                        args.synthetic_size)
    return run_test(args.model, test_set, [Top1Accuracy()], args.device)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("train", "test"):
        raise SystemExit("usage: python -m bigdl_tpu_torch.apps.lenet "
                         "{train|test} ...")
    (train if argv[0] == "train" else test)(argv[1:])


if __name__ == "__main__":
    main()
