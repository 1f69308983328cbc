"""Inception v1 on ImageNet, train (counterpart of
``bigdl_tpu/apps/inception.py``; BigDL's ``models/inception/Train.scala`` and
``ImageNet2012.scala``):

    python -m bigdl_tpu_torch.apps.inception train [-f SHARDS]
        [--caffeModel M.caffemodel | --torchModel M.t7] [--synthetic-size N]
        [-b 32] [-e 1] [-r 0.01] [--checkpoint DIR] [--device cuda|cpu]

``-f SHARDS`` trains on ``SHARDS/train`` and validates on ``SHARDS/val``,
shard folders that ``apps.seqfilegen`` writes: the shards are streamed one
at a time, decoded to BGR with the short side 256 on 8 threads, flipped
and randomly cropped to 224 for training (centre-cropped for
validation), normalised with ImageNet's channel statistics, batched and
prefetched two batches ahead. Without it, seeded N(0, 1) images at
224x224x3 with uniform labels in 1..1000 (``--synthetic-size`` records,
the same set for validation). ``--caffeModel`` copies a caffemodel's
weights into the model by layer name (unmatched layers keep theirs);
``--torchModel`` loads the whole model from a ``.t7`` file. Validation
reports Top-1 and Top-5.
"""

from __future__ import annotations

import sys

import numpy as np

from bigdl_tpu_torch.apps.common import build_optimizer, train_parser
from bigdl_tpu_torch.dataset.base import (DataSet, MTTransformer, Prefetch,
                                          Sample, SampleToBatch)
from bigdl_tpu_torch.dataset.image import (BGRImgCropper, BGRImgNormalizer,
                                           BGRImgRdmCropper, BGRImgToBatch,
                                           EncodedBytesToBGRImg, HFlip)
from bigdl_tpu_torch.dataset.shards import ShardFolder
from bigdl_tpu_torch.models import inception
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.optim import Top1Accuracy, Top5Accuracy
from bigdl_tpu_torch.utils import file_io

# ImageNet's channel statistics in BGR order (BigDL's ImageNet2012.scala:
# RGB means 0.485/0.456/0.406, stds 0.229/0.224/0.225, times 255)
_MEAN_BGR = (0.406 * 255, 0.456 * 255, 0.485 * 255)
_STD_BGR = (0.225 * 255, 0.224 * 255, 0.229 * 255)


def _synthetic_imagenet(n: int, size: int = 224, classes: int = 1000):
    rng = np.random.RandomState(11)
    return [Sample(rng.randn(size, size, 3).astype(np.float32),
                   np.float32(rng.randint(1, classes + 1))) for _ in range(n)]


def _shard_dataset(folder: str, batch: int, train: bool):
    """The ImageNet2012 pipeline over a shard folder (reference
    ``_shard_dataset``): decode on 8 threads, flip and random crop (train)
    or centre crop, normalise, batch, prefetch."""
    ds = ShardFolder.stream(folder)
    decode = MTTransformer(EncodedBytesToBGRImg(256), workers=8)
    if train:
        aug = HFlip(0.5) >> BGRImgRdmCropper(224, 224)
    else:
        aug = BGRImgCropper(224, 224, random=False)
    return (ds >> decode >> aug >> BGRImgNormalizer(_MEAN_BGR, _STD_BGR)
            >> BGRImgToBatch(batch, drop_remainder=train)
            >> Prefetch(2))


def _dataset(batch, synthetic_size, folder=None, train=True):
    if folder:
        return _shard_dataset(folder, batch, train)
    return DataSet.array(_synthetic_imagenet(synthetic_size)).transform(
        SampleToBatch(batch_size=batch))


def optimizer(argv):
    """The training run of ``argv`` (the options after ``train``) as an
    ``Optimizer``, not yet started, and the parsed arguments."""
    parser = train_parser("bigdl_tpu_torch.apps.inception train",
                          default_batch=32, default_epochs=1, default_lr=0.01)
    parser.add_argument("--caffeModel", default=None,
                        help="init weights from a .caffemodel by layer name")
    parser.add_argument("--torchModel", default=None,
                        help="init the whole model from a .t7 file")
    args = parser.parse_args(argv)
    if args.torchModel:
        from bigdl_tpu_torch.interop import load_torch
        model = load_torch(args.torchModel, device=args.device)
    else:
        model = inception.build(1000, device=args.device)
        if args.caffeModel:
            from bigdl_tpu_torch.interop import load_caffe
            model = load_caffe(model, args.caffeModel, match_all=False)
    train_folder = f"{args.folder}/train" if args.folder else None
    val_folder = f"{args.folder}/val" if args.folder else None
    opt = build_optimizer(model,
                          _dataset(args.batchSize, args.synthetic_size,
                                   train_folder, train=True),
                          ClassNLLCriterion(), args,
                          validation_set=_dataset(args.batchSize,
                                                  args.synthetic_size,
                                                  val_folder, train=False),
                          methods=[Top1Accuracy(), Top5Accuracy()])
    return opt, args


def train(argv):
    """Trains and returns the model."""
    opt, args = optimizer(argv)
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
