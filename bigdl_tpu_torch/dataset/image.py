"""Image types and in-memory transformers (counterpart of
``bigdl_tpu/dataset/image.py``: ``LabeledImage``, ``BytesToGreyImg``,
``BytesToBGRImg``, ``GreyImgNormalizer``, ``BGRImgNormalizer``,
``BGRImgCropper``, ``BGRImgRdmCropper``, ``HFlip``, ``ColorJitter``,
``Lighting``, ``GreyImgToBatch``, ``BGRImgToBatch``, ``GreyImgToSample``,
``BGRImgToSample`` and ``BGRImgPixelNormalizer`` are ported).

Images are numpy (H, W, C) float32, channels-last, with a 1-based float
label. Batches stay host numpy until ``Optimizer`` moves them to the card.
The random stages draw from ``utils.rng.RandomGenerator.RNG()`` in the
reference's order, so one seed gives the reference's crops, flips and
jitter bit for bit.

The decoders (``EncodedBytesToBGRImg``, ``LocalImgReader``,
``LocalImgReaderWithName``, ``NativeBGRBatchDecoder``,
``MTLabeledBGRImgToBatch``) are not ported: constructing one raises
``NotImplementedError`` citing ROADMAP A.3 (image decoders).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.base import (ByteRecord, MiniBatch, Sample,
                                          Transformer)
from bigdl_tpu_torch.utils.rng import RandomGenerator

DECODERS_WAITING = "ROADMAP A.3 (image decoders)"


class LabeledImage:
    """(H, W, C) float image and a 1-based label (reference
    ``LabeledImage``)."""

    __slots__ = ("data", "label")

    def __init__(self, data: np.ndarray, label: float):
        self.data = np.asarray(data, np.float32)
        self.label = float(label)

    @property
    def shape(self):
        return self.data.shape


LabeledGreyImage = LabeledImage
LabeledBGRImage = LabeledImage


class BytesToGreyImg(Transformer):
    """Row-major grey bytes to an (row, col, 1) image (reference
    ``BytesToGreyImg``)."""

    def __init__(self, row: int, col: int):
        self.row, self.col = row, col

    def __call__(self, prev: Iterator[ByteRecord]) -> Iterator[LabeledImage]:
        for rec in prev:
            img = np.frombuffer(rec.data, np.uint8).astype(np.float32)
            yield LabeledImage(img.reshape(self.row, self.col, 1), rec.label)


class BytesToBGRImg(Transformer):
    """Interleaved BGR bytes to an (row, col, 3) image (reference
    ``BytesToBGRImg``)."""

    def __init__(self, row: int, col: int):
        self.row, self.col = row, col

    def __call__(self, prev: Iterator[ByteRecord]) -> Iterator[LabeledImage]:
        for rec in prev:
            img = np.frombuffer(rec.data, np.uint8).astype(np.float32)
            yield LabeledImage(img.reshape(self.row, self.col, 3), rec.label)


class GreyImgNormalizer(Transformer):
    """(x - mean) / std with dataset-level statistics (reference
    ``GreyImgNormalizer``)."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = mean, std

    @staticmethod
    def from_dataset(dataset) -> "GreyImgNormalizer":
        total, sq, n = 0.0, 0.0, 0
        for img in dataset.data(train=False):
            total += float(img.data.sum())
            sq += float((img.data ** 2).sum())
            n += img.data.size
        mean = total / n
        std = float(np.sqrt(sq / n - mean * mean))
        return GreyImgNormalizer(mean, std)

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        for img in prev:
            yield LabeledImage((img.data - self.mean) / self.std, img.label)


class BGRImgNormalizer(Transformer):
    """Per-channel (x - mean) / std (reference ``BGRImgNormalizer``)."""

    def __init__(self, mean: Tuple[float, float, float],
                 std: Tuple[float, float, float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        for img in prev:
            yield LabeledImage((img.data - self.mean) / self.std, img.label)


class BGRImgCropper(Transformer):
    """Random or centre crop (reference ``BGRImgCropper``); a random crop
    draws its row, then its column offset."""

    def __init__(self, crop_width: int, crop_height: int, random: bool = True):
        self.cw, self.ch, self.random = crop_width, crop_height, random
        self.stochastic = random

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        rng = RandomGenerator.RNG()
        for img in prev:
            h, w = img.data.shape[:2]
            if self.random:
                y = int(rng.uniform(0, max(1, h - self.ch + 1)))
                x = int(rng.uniform(0, max(1, w - self.cw + 1)))
            else:
                y, x = (h - self.ch) // 2, (w - self.cw) // 2
            yield LabeledImage(img.data[y:y + self.ch, x:x + self.cw],
                               img.label)


#: the grey crop is the same operation on one channel (reference)
GreyImgCropper = BGRImgCropper


class BGRImgRdmCropper(BGRImgCropper):
    """Random crop after ``padding`` zeros on each spatial side (reference
    ``BGRImgRdmCropper``)."""

    def __init__(self, crop_width: int, crop_height: int, padding: int = 0):
        super().__init__(crop_width, crop_height, random=True)
        self.padding = padding

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        def padded():
            for img in prev:
                if self.padding:
                    p = self.padding
                    yield LabeledImage(np.pad(img.data, ((p, p), (p, p),
                                                         (0, 0))), img.label)
                else:
                    yield img

        return super().__call__(padded())


class HFlip(Transformer):
    """Horizontal flip with probability ``threshold`` (reference
    ``HFlip``): one uniform draw per image."""

    stochastic = True

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        rng = RandomGenerator.RNG()
        for img in prev:
            if rng.uniform() < self.threshold:
                yield LabeledImage(img.data[:, ::-1], img.label)
            else:
                yield img


class ColorJitter(Transformer):
    """Brightness, contrast and saturation jitter in a random order
    (reference ``ColorJitter``)."""

    stochastic = True

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4):
        self.brightness, self.contrast = brightness, contrast
        self.saturation = saturation

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        rng = RandomGenerator.RNG()
        for img in prev:
            d = img.data
            order = [0, 1, 2]
            rng.shuffle(order)
            for op in order:
                if op == 0 and self.brightness:
                    alpha = 1.0 + float(rng.uniform(-self.brightness,
                                                    self.brightness))
                    d = d * alpha
                elif op == 1 and self.contrast:
                    alpha = 1.0 + float(rng.uniform(-self.contrast,
                                                    self.contrast))
                    d = d * alpha + d.mean() * (1 - alpha)
                elif op == 2 and self.saturation:
                    alpha = 1.0 + float(rng.uniform(-self.saturation,
                                                    self.saturation))
                    grey = d.mean(axis=2, keepdims=True)
                    d = d * alpha + grey * (1 - alpha)
            yield LabeledImage(d, img.label)


class Lighting(Transformer):
    """AlexNet's PCA lighting noise (reference ``Lighting``)."""

    stochastic = True

    EIGVAL = np.asarray([0.2175, 0.0188, 0.0045], np.float32)
    EIGVEC = np.asarray([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alphastd: float = 0.1):
        self.alphastd = alphastd

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        rng = RandomGenerator.RNG()
        for img in prev:
            alpha = rng.normal(0.0, self.alphastd, (3,)).astype(np.float32)
            delta = (self.EIGVEC * alpha * self.EIGVAL).sum(axis=1)
            yield LabeledImage(img.data + delta, img.label)


class _ImgToBatch(Transformer):
    aggregating = True

    def __init__(self, batch_size: int, drop_remainder: bool = True):
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[MiniBatch]:
        feats, labels = [], []
        for img in prev:
            feats.append(img.data)
            labels.append(img.label)
            if len(feats) == self.batch_size:
                yield MiniBatch(np.stack(feats), np.asarray(labels, np.float32))
                feats, labels = [], []
        if feats and not self.drop_remainder:
            yield MiniBatch(np.stack(feats), np.asarray(labels, np.float32))


class GreyImgToBatch(_ImgToBatch):
    """Images to (N, H, W, 1) batches and (N,) labels (reference
    ``GreyImgToBatch``); a short last batch is dropped unless
    ``drop_remainder`` is false."""


class BGRImgToBatch(_ImgToBatch):
    """Images to (N, H, W, 3) batches (reference ``BGRImgToBatch``)."""


class GreyImgToSample(Transformer):
    """reference ``GreyImgToSample``."""

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[Sample]:
        for img in prev:
            yield Sample(img.data, np.float32(img.label))


class BGRImgToSample(GreyImgToSample):
    """reference ``BGRImgToSample``."""


class BGRImgPixelNormalizer(Transformer):
    """Subtract a per-pixel mean image of the images' shape (reference
    ``BGRImgPixelNormalizer``)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        for img in prev:
            if img.data.shape != self.means.shape:
                raise ValueError(f"mean image shape {self.means.shape} != "
                                 f"image shape {img.data.shape}")
            yield LabeledImage(img.data - self.means, img.label)


class _Decoder(Transformer):
    """A decoder of the reference that the port does not have yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{type(self).__name__} is not ported "
                                  f"yet: {DECODERS_WAITING}")


class EncodedBytesToBGRImg(_Decoder):
    """reference ``EncodedBytesToBGRImg`` (JPEG/PNG bytes through Pillow)."""


class LocalImgReader(_Decoder):
    """reference ``LocalImgReader`` (image files through Pillow)."""


class LocalImgReaderWithName(_Decoder):
    """reference ``LocalImgReaderWithName``."""


class NativeBGRBatchDecoder(_Decoder):
    """reference ``NativeBGRBatchDecoder`` (the native batch decoder)."""


class MTLabeledBGRImgToBatch(_Decoder):
    """reference ``MTLabeledBGRImgToBatch`` (threaded decode and collate)."""
