"""The image pipeline in the port against the JAX package's, on the CPU.

Every ported transform gives the reference's arrays bit for bit from the
same records when both packages' ``RandomGenerator.RNG()`` carry one
seed (the random stages draw in the reference's order); the MNIST reader
on the vendored ``tests/resources/mnist/`` (plain and gzip) and the CIFAR
reader on binary files the test writes return the reference's records;
``Prefetch`` keeps order, validates its depth, sits in a ``>>`` chain and
hands an upstream error to the consumer. Each decoder, once a stub that
refused with its ROADMAP label, decodes a seeded PNG as the reference's
does (``test_torch_image_decoders.py`` holds them at length).
"""

import gzip
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from bigdl_tpu.dataset import base as jbase
from bigdl_tpu.dataset import cifar as jcifar
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import mnist as jmnist
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.dataset import base, cifar, image, mnist
from bigdl_tpu_torch.utils.rng import RandomGenerator

MNIST = Path(__file__).resolve().parent / "resources" / "mnist"


def _images(n=6, hw=(10, 12), c=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, (*hw, c)).astype(np.float32),
             float(rng.integers(1, 11))) for _ in range(n)]


def _run(pkg_image, rng_cls, stages, records, seed=5):
    """The records through ``stages`` (built by ``stages(pkg_image)``) with
    the package's generator seeded; the outputs' arrays and labels."""
    rng_cls.RNG().set_seed(seed)
    chain = None
    for st in stages(pkg_image):
        chain = st if chain is None else chain >> st
    items = [pkg_image.LabeledImage(d, l) for d, l in records]
    out = []
    for item in chain(iter(items)):
        if hasattr(item, "labels"):
            out.append((item.data, item.labels))
        elif hasattr(item, "feature"):
            out.append((item.feature, item.label))
        else:
            out.append((item.data, item.label))
    return out


def _equal(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (da, la), (db, lb) in zip(a, b):
        assert np.asarray(da).dtype == np.asarray(db).dtype
        assert np.array_equal(np.asarray(da), np.asarray(db))
        assert np.array_equal(np.asarray(la), np.asarray(lb))


MEAN, STD = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)
CHAINS = {
    "normalize": lambda m: [m.BGRImgNormalizer(MEAN, STD)],
    "crop_random": lambda m: [m.BGRImgCropper(7, 5)],
    "crop_center": lambda m: [m.BGRImgCropper(7, 5, random=False)],
    "rdm_crop_padded": lambda m: [m.BGRImgRdmCropper(10, 12, padding=4)],
    "hflip": lambda m: [m.HFlip(0.5)],
    "color_jitter": lambda m: [m.ColorJitter()],
    "lighting": lambda m: [m.Lighting(0.1)],
    "pixel_normalize": lambda m: [m.BGRImgPixelNormalizer(
        np.full((10, 12, 3), 100.0, np.float32))],
    "to_sample": lambda m: [m.BGRImgToSample()],
    "to_batch": lambda m: [m.BGRImgToBatch(4)],
    "to_batch_keep_tail": lambda m: [m.BGRImgToBatch(4,
                                                     drop_remainder=False)],
    # the vgg and resnet apps' training chain: draws interleave per image
    "cifar_train": lambda m: [m.BGRImgNormalizer(MEAN, STD), m.HFlip(0.5),
                              m.BGRImgRdmCropper(10, 12, padding=4),
                              m.BGRImgToBatch(3)],
    "imagenet_aug": lambda m: [m.HFlip(0.5), m.BGRImgCropper(8, 8),
                               m.ColorJitter(), m.Lighting(),
                               m.BGRImgNormalizer(MEAN, STD),
                               m.BGRImgToBatch(2)],
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_transforms_equal_the_reference(name):
    records = _images()
    _equal(_run(image, RandomGenerator, CHAINS[name], records),
           _run(jimage, JaxRNG, CHAINS[name], records))


def test_random_stages_follow_the_seed():
    records = _images()
    a = _run(image, RandomGenerator, CHAINS["imagenet_aug"], records, seed=1)
    b = _run(image, RandomGenerator, CHAINS["imagenet_aug"], records, seed=2)
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))


def _grey_records(pkg_base, n=5):
    rng = np.random.default_rng(3)
    return [pkg_base.ByteRecord(rng.integers(0, 256, 28 * 28, np.uint8)
                                .tobytes(), float(i % 10 + 1))
            for i in range(n)]


@pytest.mark.parametrize("to", ["batch", "sample"])
def test_grey_chain_equals_the_reference(to):
    def chain(m, pkg_base):
        last = m.GreyImgToBatch(2, drop_remainder=False) if to == "batch" \
            else m.GreyImgToSample()
        return (m.BytesToGreyImg(28, 28) >> m.GreyImgNormalizer(33.0, 78.0)
                >> last)
    got = list(chain(image, base)(iter(_grey_records(base))))
    ref = list(chain(jimage, jbase)(iter(_grey_records(jbase))))
    pick = (lambda b: (b.data, b.labels)) if to == "batch" else (
        lambda s: (s.feature, s.label))
    _equal([pick(b) for b in got], [pick(b) for b in ref])


def test_bytes_to_bgr_and_normalizer_from_dataset():
    rng = np.random.default_rng(4)
    raw = [rng.integers(0, 256, 4 * 5 * 3, np.uint8).tobytes()
           for _ in range(3)]
    got = list(image.BytesToBGRImg(4, 5)(iter(
        [base.ByteRecord(r, 2.0) for r in raw])))
    ref = list(jimage.BytesToBGRImg(4, 5)(iter(
        [jbase.ByteRecord(r, 2.0) for r in raw])))
    _equal([(g.data, g.label) for g in got], [(r.data, r.label) for r in ref])
    grey = [image.LabeledImage(d[..., :1], l) for d, l in _images(4)]
    jgrey = [jimage.LabeledImage(d[..., :1], l) for d, l in _images(4)]
    n = image.GreyImgNormalizer.from_dataset(base.DataSet.array(grey))
    jn = jimage.GreyImgNormalizer.from_dataset(jbase.DataSet.array(jgrey))
    assert (n.mean, n.std) == (jn.mean, jn.std)


def test_pixel_normalizer_checks_the_shape():
    with pytest.raises(ValueError, match="mean image shape"):
        list(image.BGRImgPixelNormalizer(np.zeros((2, 2, 3)))(
            iter([image.LabeledImage(np.zeros((3, 3, 3)), 1.0)])))


def _records(recs):
    return [(r.data, r.label) for r in recs]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("gz", [False, True])
def test_mnist_reader(tmp_path, train, gz):
    folder = MNIST
    if gz:   # the same files gzip-compressed, read through load()
        for f in os.listdir(MNIST):
            with open(MNIST / f, "rb") as src, \
                    gzip.open(tmp_path / (f + ".gz"), "wb") as dst:
                shutil.copyfileobj(src, dst)
        prefix = "train" if train else "t10k"
        got = mnist.load(str(tmp_path / f"{prefix}-images-idx3-ubyte.gz"),
                         str(tmp_path / f"{prefix}-labels-idx1-ubyte.gz"))
    else:
        got = mnist.load_dir(str(folder), train)
    ref = jmnist.load_dir(str(MNIST), train)
    assert len(got) == 32
    assert _records(got) == _records(ref)
    assert all(1.0 <= r.label <= 10.0 for r in got)


def test_mnist_reader_refuses_bad_magic(tmp_path):
    (tmp_path / "l").write_bytes(b"\x00\x00\x08\x02" + b"\x00" * 8)
    with pytest.raises(ValueError, match="magic"):
        mnist.load(str(tmp_path / "i"), str(tmp_path / "l"))


def test_mnist_synthetic_equals_the_reference():
    assert _records(mnist.synthetic(20)) == _records(jmnist.synthetic(20))
    assert (mnist.TRAIN_MEAN, mnist.TRAIN_STD) == (jmnist.TRAIN_MEAN,
                                                   jmnist.TRAIN_STD)


def _write_cifar(path, n, seed):
    rng = np.random.default_rng(seed)
    recs = [bytes([int(rng.integers(0, 10))])
            + rng.integers(0, 256, 3072, np.uint8).tobytes()
            for _ in range(n)]
    path.write_bytes(b"".join(recs))


def test_cifar_reader(tmp_path):
    for i in range(1, 6):
        _write_cifar(tmp_path / f"data_batch_{i}.bin", 3, i)
    _write_cifar(tmp_path / "test_batch.bin", 4, 9)
    for train in (True, False):
        got = cifar.load_dir(str(tmp_path), train)
        ref = jcifar.load_dir(str(tmp_path), train)
        assert len(got) == (15 if train else 4)
        _equal(_records(got), _records(ref))
    img = cifar.load_bin(str(tmp_path / "test_batch.bin"))[0]
    raw = (tmp_path / "test_batch.bin").read_bytes()[:3073]
    assert img.label == raw[0] + 1.0
    # CHW bytes to channels-last floats
    assert img.data[2, 5, 1] == raw[1 + 1024 + 2 * 32 + 5]
    _equal(_records(cifar.synthetic(6)), _records(jcifar.synthetic(6)))


def test_prefetch_keeps_order_and_chains():
    records = _images(7)
    got = _run(image, RandomGenerator,
               lambda m: [m.HFlip(0.5), m.BGRImgToBatch(2),
                          base.Prefetch(2)], records)
    ref = _run(jimage, JaxRNG,
               lambda m: [m.HFlip(0.5), m.BGRImgToBatch(2),
                          jbase.Prefetch(2)], records)
    _equal(got, ref)
    assert list(base.Prefetch(1)(iter(range(50)))) == list(range(50))
    ds = (base.DataSet.array([image.LabeledImage(d, l) for d, l in records])
          >> image.BGRImgToBatch(3) >> base.Prefetch(3))
    assert [b.size() for b in ds.data(train=False)] == [3, 3]


def test_prefetch_depth_errors_and_abandoned_consumer():
    with pytest.raises(ValueError, match="depth"):
        base.Prefetch(0)

    def broken():
        yield 1
        raise RuntimeError("upstream failed")
    it = base.Prefetch(2)(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="upstream failed"):
        next(it)
    it = base.Prefetch(1)(iter(range(1000)))
    assert next(it) == 0
    it.close()   # the producer thread gives up on its full queue


def _decoder_case(pkg_image, pkg_base, name, path, raw):
    """``name`` of ``pkg_image`` built as the ROADMAP-labelled stub was
    (first argument 256) and run on one seeded image; its arrays."""
    if name == "EncodedBytesToBGRImg":
        out = pkg_image.EncodedBytesToBGRImg(256)(
            iter([pkg_base.ByteRecord(open(path, "rb").read(), 2.0)]))
    elif name == "LocalImgReader":
        out = pkg_image.LocalImgReader(256)(iter([(path, 2.0)]))
    elif name == "LocalImgReaderWithName":
        out = (img for _, img in
               pkg_image.LocalImgReaderWithName(256)(iter([(path, 2.0)])))
    elif name == "NativeBGRBatchDecoder":
        out = pkg_image.NativeBGRBatchDecoder(
            256, 1, 1, (104.0, 117.0, 123.0), (58.0, 57.0, 57.0))(
            iter([pkg_base.ByteRecord(raw, 2.0)]))
    else:
        imgs = pkg_image.LocalImgReader(256)(iter([(path, 2.0)]))
        out = pkg_image.MTLabeledBGRImgToBatch(
            256, 256, 1, pkg_image.BGRImgCropper(256, 256, random=False),
            workers=2)(imgs)
    return [np.asarray(o.data) for o in out]


@pytest.mark.parametrize("name", ["EncodedBytesToBGRImg", "LocalImgReader",
                                  "LocalImgReaderWithName",
                                  "NativeBGRBatchDecoder",
                                  "MTLabeledBGRImgToBatch"])
def test_decoders_refuse_with_their_roadmap_label(name, tmp_path):
    """Each decoder now works: it gives the reference's arrays."""
    from PIL import Image
    rng = np.random.default_rng(3)
    path = str(tmp_path / "x.png")
    Image.fromarray(rng.integers(0, 256, (300, 270, 3), dtype=np.uint8)
                    ).save(path)
    raw = rng.integers(0, 256, 256 * 3, dtype=np.uint8).tobytes()
    got = _decoder_case(image, base, name, path, raw)
    want = _decoder_case(jimage, jbase, name, path, raw)
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape
    assert np.abs(got[0] - want[0]).max() <= 1e-6
