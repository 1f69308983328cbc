"""The MNIST autoencoder's train main (counterpart of
``bigdl_tpu/apps/autoencoder.py``):

    python -m bigdl_tpu_torch.apps.autoencoder train [-f MNIST_DIR]
        [-b 150] [-e 5] [-r 0.01] [--checkpoint DIR] [--device cuda|cpu]

Images scaled to [0, 1] are both input and target of an MSE
reconstruction (784 -> 32 -> 784); every epoch validates
``Loss(MSECriterion())`` on the training set, as the reference does.
Without ``-f`` the data is ``mnist.synthetic``. ``optimizer(argv)`` is
the same run as an unstarted ``Optimizer``.
"""

from __future__ import annotations

import sys

import numpy as np

from bigdl_tpu_torch.apps.common import build_optimizer, train_parser
from bigdl_tpu_torch.dataset import mnist
from bigdl_tpu_torch.dataset.base import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models import autoencoder
from bigdl_tpu_torch.nn.criterion import MSECriterion
from bigdl_tpu_torch.optim import Loss
from bigdl_tpu_torch.utils import file_io


def dataset(folder, batch: int, synthetic_size: int = 2048, seed=None):
    """The training images as Samples whose label is the image itself,
    shuffled each epoch from ``seed`` (None: from the system, as the
    reference's)."""
    records = (mnist.load_dir(folder, train=True) if folder
               else mnist.synthetic(synthetic_size))
    samples = []
    for r in records:
        img = (np.frombuffer(r.data, np.uint8)[-784:]
               .reshape(784).astype(np.float32) / 255.0)
        samples.append(Sample(img, img))  # the target is the input
    return DataSet.array(samples, seed=seed).transform(
        SampleToBatch(batch_size=batch))


def parser():
    return train_parser("bigdl_tpu_torch.apps.autoencoder train",
                        default_batch=150, default_lr=0.01)


def optimizer(argv):
    """The training run of ``argv`` as an ``Optimizer``, not yet started
    (SGD from the parsed rates)."""
    args = parser().parse_args(argv)
    ds = dataset(args.folder, args.batchSize, args.synthetic_size)
    return build_optimizer(autoencoder.build(32, device=args.device), ds,
                           MSECriterion(), args, validation_set=ds,
                           methods=[Loss(MSECriterion())])


def train(argv):
    """Trains and returns the model (saved as ``model_final`` under
    ``--checkpoint``)."""
    opt = optimizer(argv)
    trained = opt.optimize()
    if opt.checkpoint_path:   # --checkpoint
        file_io.save(trained, file_io.join(opt.checkpoint_path,
                                           "model_final"))
    return trained


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "train":
        raise SystemExit("usage: python -m bigdl_tpu_torch.apps.autoencoder "
                         "train ...")
    train(argv[1:])


if __name__ == "__main__":
    main()
