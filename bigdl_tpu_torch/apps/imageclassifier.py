"""Batch image classification (counterpart of
``bigdl_tpu/apps/imageclassifier.py``; BigDL's
``example/imageclassification/ImagePredictor.scala``): load a model as
``modelvalidator`` does, predict every image of a folder, print one
``path<TAB>class`` row per image (classes 1-based).

    python -m bigdl_tpu_torch.apps.imageclassifier -f photos/ \
        -m alexnet -t caffe --caffeDefPath deploy.prototxt \
        --modelPath bvlc_alexnet.caffemodel -b 32 [--device cuda|cpu]
"""

from __future__ import annotations

import logging
import os

import torch

from bigdl_tpu_torch.apps import modelvalidator
from bigdl_tpu_torch.dataset.base import DataSet
from bigdl_tpu_torch.dataset.image import (IMAGE_EXTENSIONS, BGRImgCropper,
                                           BGRImgNormalizer, BGRImgToBatch,
                                           LocalImgReader)
from bigdl_tpu_torch.optim import Predictor
from bigdl_tpu_torch.utils.logger_filter import redirect_logs

log = logging.getLogger("bigdl_tpu_torch.optim")


def list_images(folder: str):
    """The image files under ``folder`` (flat or nested), sorted; other
    files are skipped."""
    paths = []
    for root, _, names in os.walk(folder):
        for n in sorted(names):
            if n.lower().endswith(IMAGE_EXTENSIONS):
                paths.append(os.path.join(root, n))
    return sorted(paths)


def predict_folder(model, folder: str, batch_size: int, crop: int, mean,
                   std, device="cuda"):
    """(path, 1-based predicted class) rows, the model on ``device``."""
    paths = list_images(folder)
    if not paths:
        return []
    ds = (DataSet.array([(p, 0.0) for p in paths])
          >> LocalImgReader(scale_to=max(256, crop))
          >> BGRImgCropper(crop, crop, random=False)
          >> BGRImgNormalizer(mean, std)
          >> BGRImgToBatch(batch_size, drop_remainder=False))
    preds = Predictor(model, batch_size, device=device).predict_class(ds)
    flat = torch.cat(preds).cpu().numpy()
    return list(zip(paths, flat[:len(paths)].tolist()))


def main(argv=None) -> list:
    """Prints and returns the rows."""
    args = modelvalidator.parser(
        "bigdl_tpu_torch.apps.imageclassifier").parse_args(argv)
    redirect_logs()

    _, crop, mean, std = modelvalidator.model_config(args.modelName)
    model = modelvalidator.load_model(args)
    rows = predict_folder(model, args.folder, args.batchSize,
                          args.imageSize or crop, mean, std, args.device)
    for path, cls in rows:
        print(f"{path}\t{int(cls)}")
    log.info("predicted %d images", len(rows))
    return rows


if __name__ == "__main__":
    main()
