"""MNIST idx-ubyte reader and a seeded synthetic set (counterpart of
``bigdl_tpu/dataset/mnist.py``).

``load`` reads plain or gzip idx files into ``ByteRecord``s with 1-based
labels; ``load_dir`` takes the standard file names
(``train-images-idx3-ubyte``, ``t10k-labels-idx1-ubyte``, ...).
``synthetic`` draws the reference's class-separable fake digits.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List

import numpy as np

from bigdl_tpu_torch.dataset.base import ByteRecord

TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def load(features_file: str, labels_file: str) -> List[ByteRecord]:
    """idx3-ubyte images and idx1-ubyte labels as ByteRecords, labels
    shifted to 1-based."""
    with _open(labels_file) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad label magic {magic}")
        labels = np.frombuffer(f.read(n), np.uint8)
    with _open(features_file) as f:
        magic, n2, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad image magic {magic}")
        if n2 != n:
            raise ValueError(f"{n2} images but {n} labels")
        images = f.read(n * rows * cols)
    rec_len = rows * cols
    return [ByteRecord(images[i * rec_len:(i + 1) * rec_len],
                       float(labels[i]) + 1.0) for i in range(n)]


def load_dir(folder: str, train: bool) -> List[ByteRecord]:
    prefix = "train" if train else "t10k"
    return load(os.path.join(folder, f"{prefix}-images-idx3-ubyte"),
                os.path.join(folder, f"{prefix}-labels-idx1-ubyte"))


def synthetic(n: int, seed: int = 42, separable: bool = True
              ) -> List[ByteRecord]:
    """Deterministic fake MNIST: noise, and (``separable``) a bright patch
    whose position encodes the class."""
    rng = np.random.default_rng(seed)
    records = []
    for _ in range(n):
        label = int(rng.integers(0, 10))
        img = rng.integers(0, 30, (28, 28)).astype(np.uint8)
        if separable:
            r, c = divmod(label, 4)
            y, x = 3 + r * 8, 3 + c * 6
            img[y:y + 6, x:x + 6] = 220
        records.append(ByteRecord(img.tobytes(), float(label) + 1.0))
    return records
