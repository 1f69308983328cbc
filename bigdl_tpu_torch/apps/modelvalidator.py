"""Model-import validation (counterpart of
``bigdl_tpu/apps/modelvalidator.py``; BigDL's
``example/loadmodel/ModelValidator.scala``): load a BigDL, Torch or Caffe
snapshot into a named architecture and measure Top-1 and Top-5 over a
labelled image folder (one directory per class).

    python -m bigdl_tpu_torch.apps.modelvalidator \
        -t caffe -m alexnet --caffeDefPath deploy.prototxt \
        --modelPath bvlc_alexnet.caffemodel -f val_images/ -b 32 \
        [--meanFile mean.binaryproto] [--device cuda|cpu]

Images are read with Pillow (short side to max(256, crop)), centre-cropped
to the architecture's size (AlexNet 227, the rest 224, or
``--imageSize``), and have the BGR mean 104/117/123 subtracted, or a Caffe
mean image with ``--meanFile``. ``-t bigdl`` loads a ``file_io`` snapshot
and ``-t torch`` a ``.t7`` file as the whole model; ``-t caffe`` builds the
architecture and copies the caffemodel's weights in by layer name. The
model runs on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import logging
from typing import Iterator

import numpy as np

from bigdl_tpu_torch.dataset.base import DataSet, Transformer
from bigdl_tpu_torch.dataset.image import (BGRImgCropper, BGRImgNormalizer,
                                           BGRImgToBatch, LabeledImage,
                                           LocalImgReader, image_folder_paths)
from bigdl_tpu_torch.models import alexnet, inception, resnet, vgg
from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy, Top5Accuracy
from bigdl_tpu_torch.utils.logger_filter import redirect_logs

log = logging.getLogger("bigdl_tpu_torch.optim")

# name -> (builder(class_num, device), crop size, BGR mean, std)
_IMAGENET_BGR_MEAN = (104.0, 117.0, 123.0)
_MODELS = {
    "alexnet": (lambda n, device: alexnet.build(n, device=device), 227,
                _IMAGENET_BGR_MEAN, (1.0, 1.0, 1.0)),
    "inception": (lambda n, device: inception.build(n, device=device), 224,
                  _IMAGENET_BGR_MEAN, (1.0, 1.0, 1.0)),
    "vgg16": (lambda n, device: vgg.build_imagenet(n, depth=16,
                                                   device=device), 224,
              _IMAGENET_BGR_MEAN, (1.0, 1.0, 1.0)),
    "vgg19": (lambda n, device: vgg.build_imagenet(n, depth=19,
                                                   device=device), 224,
              _IMAGENET_BGR_MEAN, (1.0, 1.0, 1.0)),
    "resnet50": (lambda n, device: resnet.build(n, depth=50, device=device),
                 224, _IMAGENET_BGR_MEAN, (1.0, 1.0, 1.0)),
}


def model_config(name: str):
    """(builder, crop, mean, std) of a registry name; an unknown name
    exits with the choices."""
    if name not in _MODELS:
        raise SystemExit(f"unknown model {name!r}; "
                         f"choose from {sorted(_MODELS)}")
    return _MODELS[name]


class SubtractMeanImage(Transformer):
    """Subtract a whole mean image, centre-cropped to each image's size
    (reference ``SubtractMeanImage``)."""

    def __init__(self, mean: np.ndarray):
        self.mean = mean   # (H, W, C) BGR

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        for img in prev:
            h, w = img.data.shape[:2]
            mh, mw = self.mean.shape[:2]
            if mh < h or mw < w:
                raise ValueError(
                    f"mean image ({mh}x{mw}) is smaller than the cropped "
                    f"input ({h}x{w}); use a larger mean file or a smaller "
                    f"--imageSize")
            y, x = (mh - h) // 2, (mw - w) // 2
            yield LabeledImage(img.data - self.mean[y:y + h, x:x + w],
                               img.label)


def load_model(args):
    """The model of ``--modelType`` on ``args.device`` (reference
    ``load_model``)."""
    builder = model_config(args.modelName)[0]
    if args.modelType == "bigdl":
        from bigdl_tpu_torch.utils import file_io
        return file_io.load(args.modelPath, device=args.device)
    if args.modelType == "torch":
        from bigdl_tpu_torch.interop import load_torch
        return load_torch(args.modelPath, device=args.device)
    if args.modelType == "caffe":
        from bigdl_tpu_torch.interop import load_caffe
        model = builder(args.classNum, args.device)
        if args.caffeDefPath:
            return load_caffe(model, args.caffeDefPath, args.modelPath)
        return load_caffe(model, args.modelPath)
    raise SystemExit("only torch, caffe or bigdl supported")


def build_dataset(args):
    _, crop, mean, std = model_config(args.modelName)
    crop = args.imageSize or crop
    ds = (DataSet.array(image_folder_paths(args.folder))
          >> LocalImgReader(scale_to=max(256, crop))
          >> BGRImgCropper(crop, crop, random=False))
    if args.meanFile:
        from bigdl_tpu_torch.interop.caffe import load_mean_file
        ds = ds >> SubtractMeanImage(load_mean_file(args.meanFile))
    else:
        ds = ds >> BGRImgNormalizer(mean, std)
    return ds >> BGRImgToBatch(args.batchSize, drop_remainder=False)


def parser(prog: str = "bigdl_tpu_torch.apps.modelvalidator"):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("-f", "--folder", required=True,
                   help="labeled image folder (one subdir per class)")
    p.add_argument("-m", "--modelName", required=True,
                   help=f"one of {sorted(_MODELS)}")
    p.add_argument("-t", "--modelType", required=True,
                   choices=["torch", "caffe", "bigdl"])
    p.add_argument("--caffeDefPath", default=None)
    p.add_argument("--modelPath", required=True)
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--classNum", type=int, default=1000)
    p.add_argument("--imageSize", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="where to run the model: cuda (default) or cpu")
    return p


def validator(argv=None):
    """The parsed arguments of ``argv``, the loaded model and the labelled
    validation set, before any image is read."""
    p = parser()
    p.add_argument("--meanFile", default=None,
                   help="caffe binaryproto mean image")
    args = p.parse_args(argv)
    redirect_logs()
    return args, load_model(args), build_dataset(args)


def evaluate(args, model, dataset) -> list:
    """Prints and returns ``[(result, method)]`` for Top-1 and Top-5."""
    results = Evaluator(model, args.batchSize, device=args.device).test(
        dataset, [Top1Accuracy(), Top5Accuracy()])
    for result, method in results:
        log.info("%s is %s", method.name, result)
        print(f"{args.modelName} {method.name}: {result}")
    return results


def main(argv=None) -> list:
    """Prints and returns ``[(result, method)]`` for Top-1 and Top-5."""
    return evaluate(*validator(argv))


if __name__ == "__main__":
    main()
