"""Inception v1 on ImageNet-shaped data, train (counterpart of
``bigdl_tpu/apps/inception.py``):

    python -m bigdl_tpu_torch.apps.inception train [--synthetic-size N]
        [-b 32] [-e 1] [-r 0.01] [--checkpoint DIR] [--device cuda|cpu]

The data is seeded N(0, 1) images at 224x224x3 with uniform labels in
1..1000 (``--synthetic-size`` records, the same set for validation);
validation reports Top-1 and Top-5. What the port lacks stops the program
with the ROADMAP item that will port it: ``--folder`` (the packed-shard
pipeline, A.5), ``--caffeModel`` and ``--torchModel`` (A.6).
"""

from __future__ import annotations

import sys

import numpy as np

from bigdl_tpu_torch.apps.common import build_optimizer, train_parser
from bigdl_tpu_torch.dataset.base import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models import inception
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.optim import Top1Accuracy, Top5Accuracy
from bigdl_tpu_torch.utils import file_io

#: option attribute -> the ROADMAP item that will port it
WAITING = {"folder": "A.5 (shards)", "caffeModel": "A.6 (caffe)",
           "torchModel": "A.6 (torch_file)"}


def _synthetic_imagenet(n: int, size: int = 224, classes: int = 1000):
    rng = np.random.RandomState(11)
    return [Sample(rng.randn(size, size, 3).astype(np.float32),
                   np.float32(rng.randint(1, classes + 1))) for _ in range(n)]


def _dataset(batch, synthetic_size):
    return DataSet.array(_synthetic_imagenet(synthetic_size)).transform(
        SampleToBatch(batch_size=batch))


def train(argv):
    """Trains and returns the model."""
    parser = train_parser("bigdl_tpu_torch.apps.inception train",
                          default_batch=32, default_epochs=1, default_lr=0.01)
    parser.add_argument("--caffeModel", default=None,
                        help="init weights from a .caffemodel by layer name")
    parser.add_argument("--torchModel", default=None,
                        help="init the whole model from a .t7 file")
    args = parser.parse_args(argv)
    for name, item in WAITING.items():
        if getattr(args, name):
            raise SystemExit(f"--{name} is not ported yet: ROADMAP {item}")
    model = inception.build(1000, device=args.device)
    opt = build_optimizer(model, _dataset(args.batchSize, args.synthetic_size),
                          ClassNLLCriterion(), args,
                          validation_set=_dataset(args.batchSize,
                                                  args.synthetic_size),
                          methods=[Top1Accuracy(), Top5Accuracy()])
    trained = opt.optimize()
    if args.checkpoint:
        file_io.save(trained, file_io.join(args.checkpoint, "model_final"))
    return trained


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "train":
        raise SystemExit("usage: python -m bigdl_tpu_torch.apps.inception "
                         "train ...")
    train(argv[1:])


if __name__ == "__main__":
    main()
