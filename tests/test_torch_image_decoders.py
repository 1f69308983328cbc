"""The image decoders in the port against the reference's, on the CPU.

JPEG, PNG and BMP files at odd sizes are written with Pillow from seeded
pixels. ``EncodedBytesToBGRImg``, ``LocalImgReader`` and
``LocalImgReaderWithName`` give the reference's images and labels bit for
bit (both decode with Pillow); ``MTLabeledBGRImgToBatch`` gives its
batches and refuses a geometry the transformer does not produce;
``NativeBGRBatchDecoder`` on the host library and on its numpy path is
within 1e-6 of the reference's, and with ``device_normalize`` its raw
uint8 batch through ``nn.InputNormalize`` on the CPU is too;
``image_folder_paths``, ``BGRImgToImageVector``, ``GreyImgCropper`` and
``IMAGE_EXTENSIONS`` are the reference's.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import base as jbase
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset import base, image
from bigdl_tpu_torch.nn.normalization import InputNormalize

DECODE_ATOL = 1e-6
SIZES = [(37, 53), (64, 31), (17, 17), (90, 41)]   # (w, h)
FORMATS = [("jpg", "JPEG"), ("png", "PNG"), ("bmp", "BMP")]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(rng, w, h):
    """A smooth gradient plus noise, so the JPEG codec has structure."""
    yy, xx = np.mgrid[0:h, 0:w]
    base_img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + yy) % 256], -1)
    noise = rng.integers(0, 40, (h, w, 3))
    return np.clip(base_img + noise, 0, 255).astype(np.uint8)


@pytest.fixture
def tree(tmp_path):
    """Three classes, one format each, four sizes; a stray text file."""
    from PIL import Image
    rng = np.random.default_rng(21)
    root = tmp_path / "tree"
    for (ext, fmt), cls in zip(FORMATS, ("b_cls", "a_cls", "c_cls")):
        d = root / cls
        d.mkdir(parents=True)
        for i, (w, h) in enumerate(SIZES):
            Image.fromarray(_pixels(rng, w, h)).save(d / f"{i}.{ext}", fmt)
        (d / "notes.txt").write_text("not an image")
    (root / "loose.jpg").write_bytes(b"")   # not in a class directory
    return str(root)


def test_image_folder_paths(tree):
    got = image.image_folder_paths(tree)
    assert got == jimage.image_folder_paths(tree)
    assert len(got) == 12 and {l for _, l in got} == {1.0, 2.0, 3.0}
    everything = image.image_folder_paths(tree, extensions=None)
    assert everything == jimage.image_folder_paths(tree, extensions=None)
    assert len(everything) == 15
    assert image.IMAGE_EXTENSIONS == jimage.IMAGE_EXTENSIONS


def _same_images(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.label == r.label
        assert g.data.dtype == np.float32
        assert np.array_equal(g.data, np.asarray(r.data))


@pytest.mark.parametrize("scale_to", [256, 24, 41])
def test_readers_match_bit_for_bit(tree, scale_to):
    pairs = image.image_folder_paths(tree)
    got = list(image.LocalImgReader(scale_to)(iter(pairs)))
    ref = list(jimage.LocalImgReader(scale_to)(iter(pairs)))
    _same_images(got, ref)
    assert all(min(g.data.shape[:2]) == scale_to for g in got)
    named = list(image.LocalImgReaderWithName(scale_to)(iter(pairs)))
    jnamed = list(jimage.LocalImgReaderWithName(scale_to)(iter(pairs)))
    assert [p for p, _ in named] == [p for p, _ in jnamed] == \
        [p for p, _ in pairs]
    _same_images([i for _, i in named], [i for _, i in jnamed])


def test_encoded_bytes_decoder_matches(tree):
    pairs = image.image_folder_paths(tree)
    recs = [base.ByteRecord(open(p, "rb").read(), l) for p, l in pairs]
    jrecs = [jbase.ByteRecord(r.data, r.label) for r in recs]
    got = list(image.EncodedBytesToBGRImg(33)(iter(recs)))
    ref = list(jimage.EncodedBytesToBGRImg(33)(iter(jrecs)))
    _same_images(got, ref)
    # the file reader and the bytes decoder agree
    _same_images(got, list(image.LocalImgReader(33)(iter(pairs))))


def test_mt_batches_and_geometry(tree):
    pairs = image.image_folder_paths(tree)
    imgs = list(image.LocalImgReader(20)(iter(pairs)))
    jimgs = list(jimage.LocalImgReader(20)(iter(pairs)))
    crop = image.BGRImgCropper(16, 18, random=False)
    jcrop = jimage.BGRImgCropper(16, 18, random=False)
    got = list(image.MTLabeledBGRImgToBatch(16, 18, 5, crop, workers=3)(
        iter(imgs)))
    ref = list(jimage.MTLabeledBGRImgToBatch(16, 18, 5, jcrop, workers=3)(
        iter(jimgs)))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.data.shape == (5, 18, 16, 3)
        assert np.array_equal(g.data, np.asarray(r.data))
        assert np.array_equal(g.labels, np.asarray(r.labels))
    wrong = image.MTLabeledBGRImgToBatch(17, 18, 5, crop, workers=2)
    with pytest.raises(ValueError, match="expected 18x17"):
        list(wrong(iter(imgs)))


def _raw_records(seed, n, row, col, channels):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, row * col * channels, dtype=np.uint8)
             .tobytes(), float(i % 4 + 1)) for i in range(n)]


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("use_native", [True, False])
def test_native_batch_decoder(monkeypatch, channels, use_native):
    row, col = 11, 7
    raw = _raw_records(channels, 10, row, col, channels)
    mean, std = (104.0, 117.0, 123.0), (58.4, 57.1, 57.4)
    if channels == 1:
        mean, std = 33.3, 78.6
    kw = dict(workers=3, channels=channels, drop_remainder=False)
    if not use_native:   # the path a box without g++ runs
        monkeypatch.setattr(native, "load", lambda: None)
    native.reset_counts()
    got = list(image.NativeBGRBatchDecoder(row, col, 4, mean, std, **kw)(
        base.ByteRecord(d, l) for d, l in raw))
    assert native.counts()["bt_decode_normalize"] == (3 if use_native else 0)
    ref = list(jimage.NativeBGRBatchDecoder(row, col, 4, mean, std, **kw)(
        jbase.ByteRecord(d, l) for d, l in raw))
    assert [g.data.shape[0] for g in got] == [4, 4, 2]
    for g, r in zip(got, ref):
        assert g.data.shape == np.asarray(r.data).shape
        assert np.abs(g.data - np.asarray(r.data)).max() <= DECODE_ATOL
        assert np.array_equal(g.labels, np.asarray(r.labels))
    dropped = list(image.NativeBGRBatchDecoder(row, col, 4, mean, std,
                                               channels=channels)(
        base.ByteRecord(d, l) for d, l in raw))
    assert len(dropped) == 2


def test_device_normalize_then_input_normalize():
    row, col = 9, 13
    raw = _raw_records(4, 6, row, col, 3)
    mean, std = (104.0, 117.0, 123.0), (58.4, 57.1, 57.4)
    got = list(image.NativeBGRBatchDecoder(
        row, col, 3, mean, std, device_normalize=True)(
        base.ByteRecord(d, l) for d, l in raw))
    ref = list(jimage.NativeBGRBatchDecoder(row, col, 3, mean, std)(
        jbase.ByteRecord(d, l) for d, l in raw))
    norm = InputNormalize(mean, std)
    for g, r in zip(got, ref):
        assert g.data.dtype == np.uint8 and g.data.shape == (3, row, col, 3)
        out = norm(torch.from_numpy(g.data)).numpy()
        assert np.abs(out - np.asarray(r.data)).max() <= DECODE_ATOL


def test_record_of_the_wrong_size_is_refused():
    dec = image.NativeBGRBatchDecoder(4, 4, 2, (0, 0, 0), (1, 1, 1))
    with pytest.raises(ValueError, match="expected 48"):
        list(dec(iter([base.ByteRecord(b"\x00" * 47, 1.0)])))


def test_image_vector_and_grey_cropper():
    rng = np.random.default_rng(5)
    imgs = [image.LabeledImage(rng.normal(size=(6, 5, 3)), 2.0)
            for _ in range(3)]
    got = list(image.BGRImgToImageVector()(iter(imgs)))
    ref = list(jimage.BGRImgToImageVector()(
        iter([jimage.LabeledImage(i.data, i.label) for i in imgs])))
    for g, r in zip(got, ref):
        assert g.feature.shape == (90,)
        assert np.array_equal(g.feature, np.asarray(r.feature))
        assert float(g.label) == float(r.label)
    grey = [image.LabeledImage(rng.normal(size=(8, 7, 1)), 1.0)]
    out = list(image.GreyImgCropper(3, 4, random=False)(iter(grey)))
    jout = list(jimage.GreyImgCropper(3, 4, random=False)(
        iter([jimage.LabeledImage(grey[0].data, 1.0)])))
    assert np.array_equal(out[0].data, np.asarray(jout[0].data))


def test_unreadable_image_raises_as_the_reference(tmp_path):
    from PIL import UnidentifiedImageError
    bad = tmp_path / "x.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(UnidentifiedImageError):
        list(image.LocalImgReader()(iter([(str(bad), 1.0)])))
    with pytest.raises(UnidentifiedImageError):
        list(jimage.LocalImgReader()(iter([(str(bad), 1.0)])))
