"""CIFAR-10 binary reader and a seeded synthetic set (counterpart of
``bigdl_tpu/dataset/cifar.py``).

A binary batch file holds records of one label byte and 3,072 CHW image
bytes; ``load_bin`` returns channels-last (32, 32, 3) float
``LabeledImage``s with 1-based labels. ``load_dir`` reads
``data_batch_1..5.bin`` (train) or ``test_batch.bin``.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from bigdl_tpu_torch.dataset.image import LabeledImage

TRAIN_MEAN = (125.3, 123.0, 113.9)
TRAIN_STD = (63.0, 62.1, 66.7)


def load_bin(path: str) -> List[LabeledImage]:
    out = []
    with open(path, "rb") as f:
        data = f.read()
    rec = 3073
    for i in range(len(data) // rec):
        chunk = data[i * rec:(i + 1) * rec]
        label = float(chunk[0]) + 1.0
        img = np.frombuffer(chunk, np.uint8, count=3072, offset=1)
        img = img.reshape(3, 32, 32).transpose(1, 2, 0).astype(np.float32)
        out.append(LabeledImage(img, label))
    return out


def load_dir(folder: str, train: bool) -> List[LabeledImage]:
    if train:
        files = [os.path.join(folder, f"data_batch_{i}.bin")
                 for i in range(1, 6)]
    else:
        files = [os.path.join(folder, "test_batch.bin")]
    out: List[LabeledImage] = []
    for f in files:
        out.extend(load_bin(f))
    return out


def synthetic(n: int, seed: int = 7) -> List[LabeledImage]:
    """Class-separable fake CIFAR: N(120, 20) noise and a bright patch
    whose place and channel encode the class."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = int(rng.integers(0, 10))
        img = rng.normal(120.0, 20.0, (32, 32, 3)).astype(np.float32)
        r, c = divmod(label, 4)
        img[4 + r * 8:10 + r * 8, 4 + c * 7:10 + c * 7, label % 3] += 120.0
        out.append(LabeledImage(img, float(label) + 1.0))
    return out
