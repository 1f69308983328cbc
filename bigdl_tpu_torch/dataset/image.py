"""Image types, transformers and decoders (counterpart of
``bigdl_tpu/dataset/image.py``, all of it).

Images are numpy (H, W, C) float32, channels-last, with a 1-based float
label. Batches stay host numpy until ``Optimizer`` moves them to the card.
The random stages draw from ``utils.rng.RandomGenerator.RNG()`` in the
reference's order, so one seed gives the reference's crops, flips and
jitter bit for bit.

The decoders read JPEG, PNG, BMP and the rest through Pillow, as the
reference does (RGB, the short side scaled to ``scale_to``, then BGR
float32): ``EncodedBytesToBGRImg`` (shard records), ``LocalImgReader`` and
``LocalImgReaderWithName`` (files). ``NativeBGRBatchDecoder`` turns raw
uint8 records into a batch in one call into the host library
(``native.decode_normalize``); with ``device_normalize=True`` it emits the
raw uint8 batch instead, for ``nn.InputNormalize`` to cast and normalise
on the card.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.base import (ByteRecord, MiniBatch, Sample,
                                          Transformer)
from bigdl_tpu_torch.utils.rng import RandomGenerator


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


def _decode_scaled_bgr(source, scale_to: int, who: str) -> np.ndarray:
    """Decode with Pillow: RGB, the short side to ``scale_to`` (the long side
    truncated, as the reference's ``int``), BGR float32."""
    try:
        from PIL import Image as PILImage
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(f"{who} requires Pillow") from e
    with PILImage.open(source) as im:
        im = im.convert("RGB")
        w, h = im.size
        if min(w, h) != scale_to:
            if w < h:
                im = im.resize((scale_to, int(h * scale_to / w)))
            else:
                im = im.resize((int(w * scale_to / h), scale_to))
        return np.asarray(im, np.float32)[:, :, ::-1]


class EncodedBytesToBGRImg(Transformer):
    """Encoded image bytes (a shard's records) to a scaled BGR image
    (reference ``EncodedBytesToBGRImg``)."""

    def __init__(self, scale_to: int = 256):
        self.scale_to = scale_to

    def __call__(self, prev: Iterator[ByteRecord]) -> Iterator[LabeledImage]:
        import io
        for rec in prev:
            arr = _decode_scaled_bgr(io.BytesIO(rec.data), self.scale_to,
                                     type(self).__name__)
            yield LabeledImage(arr, rec.label)


class LocalImgReader(Transformer):
    """(path, label) items to scaled BGR images read from disk (reference
    ``LocalImgReader``)."""

    def __init__(self, scale_to: int = 256):
        self.scale_to = scale_to

    def __call__(self, prev: Iterator[Tuple[str, float]]
                 ) -> Iterator[LabeledImage]:
        for path, label in prev:
            yield LabeledImage(
                _decode_scaled_bgr(path, self.scale_to, type(self).__name__),
                label)


class LocalImgReaderWithName(LocalImgReader):
    """``LocalImgReader`` yielding (path, image), so predictions join back
    to their files (reference ``LocalImgReaderWithName``)."""

    def __call__(self, prev: Iterator[Tuple[str, float]]):
        for path, label in prev:
            yield path, LabeledImage(
                _decode_scaled_bgr(path, self.scale_to, type(self).__name__),
                label)


IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp",
                    ".ppm", ".tif", ".tiff")


class MTLabeledBGRImgToBatch(Transformer):
    """Per-image ``transformer`` on ``workers`` threads, then batches of
    ``batch_size`` (reference ``MTLabeledBGRImgToBatch``:
    ``MTTransformer(transformer) >> BGRImgToBatch``); a batch whose images
    are not ``height`` x ``width`` raises."""

    aggregating = True

    def __init__(self, width: int, height: int, batch_size: int,
                 transformer: Transformer, workers: int = 4):
        from bigdl_tpu_torch.dataset.base import MTTransformer
        self.width, self.height = width, height
        self._chain = (MTTransformer(transformer, workers=workers)
                       >> BGRImgToBatch(batch_size))

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[MiniBatch]:
        for batch in self._chain(prev):
            h, w = batch.data.shape[1:3]
            if (h, w) != (self.height, self.width):
                raise ValueError(
                    f"transformed images are {h}x{w}, expected "
                    f"{self.height}x{self.width} (the declared batch "
                    "geometry — add a cropper/resizer to the transformer)")
            yield batch


class NativeBGRBatchDecoder(Transformer):
    """Raw uint8 records (``row`` x ``col`` x ``channels``, interleaved) to
    a batch in one call into the host library, ``(x - mean) / std`` per
    channel fused in, on ``workers`` threads (reference
    ``NativeBGRBatchDecoder``; ``native.decode_normalize``). With
    ``device_normalize=True`` the batch stays raw uint8 (a quarter of the
    bytes to the card) and an ``nn.InputNormalize`` first in the model
    casts and normalises it there. A short last batch is dropped unless
    ``drop_remainder`` is false."""

    aggregating = True

    def __init__(self, row: int, col: int, batch_size: int,
                 mean: Tuple[float, float, float],
                 std: Tuple[float, float, float],
                 workers: int = 4, channels: int = 3,
                 drop_remainder: bool = True,
                 device_normalize: bool = False):
        self.row, self.col, self.channels = row, col, channels
        self.batch_size = batch_size
        self.workers = workers
        self.drop_remainder = drop_remainder
        self.device_normalize = device_normalize
        n = 1 if channels == 1 else channels
        self.mean = np.ascontiguousarray(
            np.broadcast_to(np.asarray(mean, np.float32), (n,)))
        self.rstd = np.ascontiguousarray(
            1.0 / np.broadcast_to(np.asarray(std, np.float32), (n,)))

    def _shape(self, n: int) -> tuple:
        return ((n, self.row, self.col, self.channels) if self.channels > 1
                else (n, self.row, self.col))

    def _decode(self, raw: np.ndarray, labels) -> MiniBatch:
        from bigdl_tpu_torch import native
        n = raw.shape[0]
        if self.device_normalize:
            out = raw.reshape(self._shape(n)).copy()
        else:
            out = native.decode_normalize(raw, self.mean, self.rstd,
                                          self.channels, self.workers)
            out = out.reshape(self._shape(n))
        return MiniBatch(out, np.asarray(labels, np.float32))

    def __call__(self, prev: Iterator[ByteRecord]) -> Iterator[MiniBatch]:
        rec_len = self.row * self.col * self.channels
        raw = np.empty((self.batch_size, rec_len), np.uint8)
        labels: list = []
        for rec in prev:
            data = np.frombuffer(rec.data, np.uint8)
            if data.size != rec_len:
                raise ValueError(f"record has {data.size} bytes, expected "
                                 f"{rec_len} ({self.row}x{self.col}x"
                                 f"{self.channels})")
            raw[len(labels)] = data
            labels.append(rec.label)
            if len(labels) == self.batch_size:
                yield self._decode(raw, labels)
                labels = []
        if labels and not self.drop_remainder:
            yield self._decode(raw[:len(labels)], labels)


class BGRImgToImageVector(Transformer):
    """Images to flat f32 feature vectors (reference
    ``BGRImgToImageVector``), for ``ml.DLClassifier``."""

    def __call__(self, prev: Iterator[LabeledImage]) -> Iterator[Sample]:
        for img in prev:
            yield Sample(np.asarray(img.data, np.float32).ravel(), img.label)


def image_folder_paths(folder: str, extensions=IMAGE_EXTENSIONS):
    """(path, 1-based label) pairs of a labelled image tree: one directory
    per class, labels by sorted class name, files sorted by name
    (reference ``image_folder_paths``; BigDL's ``DataSet.ImageFolder``).
    ``extensions=None`` keeps every regular file."""
    import os
    pairs = []
    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))
    for label, cls in enumerate(classes, start=1):
        cls_dir = os.path.join(folder, cls)
        for name in sorted(os.listdir(cls_dir)):
            p = os.path.join(cls_dir, name)
            if not os.path.isfile(p):
                continue
            if extensions and not name.lower().endswith(extensions):
                continue
            pairs.append((p, float(label)))
    return pairs
