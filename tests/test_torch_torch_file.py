"""Torch7 ``.t7`` files in the port against the reference's, on the CPU.

The same object tree written by both packages gives the same bytes:
numbers, strings, booleans, nil, tables with mixed keys, tensors of each
dtype, an object shared twice (written once, read back as one object),
and whole modules (LeNet, VGG-CIFAR with its batch norms, a grouped conv,
containers) carrying the reference's weights. Each package loads the
other's module file, and their eval forwards agree within 1e-5. The
class table's refusals (Inception v1's ``SpatialCrossMapLRN``, ResNet's
``CAddTable``) and the corrupt-geometry refusal are the reference's;
``load_torch`` builds on the card unless the CPU is asked for.
"""

import struct

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.interop import torch_file as jtf
from bigdl_tpu.models import inception as jinception
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import load_torch, save_torch
from bigdl_tpu_torch.interop import torch_file as tf
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state
from bigdl_tpu_torch.models import inception, lenet, resnet, vgg

FORWARD_ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    for g in ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3"):
        monkeypatch.delenv(g, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(writer_cls, obj, path):
    with open(path, "wb") as f:
        writer_cls(f).write_object(obj)
    return open(path, "rb").read()


def _read(reader_cls, path):
    with open(path, "rb") as f:
        return reader_cls(f).read_object()


def _tree_equal(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_tree_equal(a[k], b[k]) for k in a))
    return a == b and type(a) is type(b)


SHARED = np.arange(4, dtype=np.float32)
TREES = {
    "float": 3.5, "int": 7, "negative": -2.25, "string": "hello, t7",
    "true": True, "false": False, "nil": None,
    "table": {1: 10.0, 2: "two", "name": "x", 3: {1: 1.0, "deep": [1][0]}},
    "empty_table": {},
    "shared": {1: SHARED, 2: SHARED, "again": {1: SHARED}},
    "torch_object": tf.TorchObject("nn.Custom", {"a": 1.0, "t": SHARED}),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_object_trees_byte_equal_and_read_across(tmp_path, name):
    obj = TREES[name]
    jobj = obj
    if isinstance(obj, tf.TorchObject):
        jobj = jtf.TorchObject(obj.torch_type, obj.fields)
    port = _bytes(tf._Writer, obj, tmp_path / "p.t7")
    ref = _bytes(jtf._Writer, jobj, tmp_path / "r.t7")
    assert port == ref
    got = _read(tf._Reader, tmp_path / "r.t7")
    want = _read(jtf._Reader, tmp_path / "p.t7")
    if isinstance(obj, tf.TorchObject):
        assert got.torch_type == want.torch_type == "nn.Custom"
        got, want = got.fields, want.fields
    assert _tree_equal(got, want)
    if name == "shared":
        assert got[1] is got[2] is got["again"][1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64,
                                   np.int32, np.int16, np.uint8, np.int8])
def test_tensors_of_each_dtype(tmp_path, dtype):
    arr = (np.random.default_rng(1).random((3, 4, 2)) * 100).astype(dtype)
    for a in (arr, arr[:, ::2].T, np.zeros((0,), dtype)):
        port = _bytes(tf._Writer, a, tmp_path / "p.t7")
        assert port == _bytes(jtf._Writer, a, tmp_path / "r.t7")
        got = _read(tf._Reader, tmp_path / "r.t7")
        assert got.dtype == dtype and np.array_equal(got, a)


def test_other_dtypes_are_written_as_float(tmp_path):
    a = np.arange(5, dtype=np.float16)
    assert _bytes(tf._Writer, a, tmp_path / "p.t7") == \
        _bytes(jtf._Writer, a, tmp_path / "r.t7")
    assert _read(tf._Reader, tmp_path / "p.t7").dtype == np.float32
    with pytest.raises(TypeError, match="cannot serialize"):
        _bytes(tf._Writer, object(), tmp_path / "x.t7")


def test_corrupt_geometry_and_truncation_rejected(tmp_path):
    p = str(tmp_path / "corrupt.t7")
    with open(p, "wb") as f:
        w = tf._Writer(f)
        w.write_int(4)
        w.write_int(1)
        w.write_string("V 1")
        w.write_string("torch.FloatTensor")
        w.write_int(1)
        w.write_long(100)      # 100 elements ...
        w.write_long(1)
        w.write_long(1)
        w.write_int(4)
        w.write_int(2)
        w.write_string("V 1")
        w.write_string("torch.FloatStorage")
        w.write_long(4)        # ... in a storage of 4
        f.write(struct.pack("<4f", 1, 2, 3, 4))
    with pytest.raises(ValueError, match="out of bounds"):
        load_torch(p, as_module=False)
    with pytest.raises(ValueError, match="out of bounds"):
        jtf.load_torch(p, as_module=False)
    data = open(p, "rb").read()
    open(p, "wb").write(data[:10])
    with pytest.raises(EOFError):
        load_torch(p, as_module=False)


def test_functions_are_skipped(tmp_path):
    p = str(tmp_path / "fn.t7")
    with open(p, "wb") as f:
        w = tf._Writer(f)
        w.write_int(tf.TYPE_TABLE)
        w.write_int(99)        # an index the writer will not hand out
        w.write_int(2)
        w.write_object("f")
        w.write_int(tf.TYPE_FUNCTION)
        w.write_int(3)
        f.write(b"\x1bLu")
        w.write_object({})
        w.write_object("x")
        w.write_object(1.0)
    assert load_torch(p, as_module=False) == \
        jtf.load_torch(p, as_module=False) == {"f": None, "x": 1.0}


def _carried(jm, tm):
    import_tree_state(tm, flatten_tree(jm.parameter_tree()),
                      flatten_tree(jm.buffer_tree()))
    return tm


def _reference_vgg():
    rng = JaxRNG.RNG()
    seed = rng.get_seed()
    rng.set_seed(1)
    try:
        return jvgg.build(10)
    finally:
        rng.set_seed(seed)


def _containers(mod):
    return (mod.Sequential()
            .add(mod.Concat(1)
                 .add(mod.SpatialConvolution(3, 2, 1, 1))
                 .add(mod.SpatialMaxPooling(3, 3, 1, 1, 1, 1)))
            .add(mod.SpatialAveragePooling(2, 2, 2, 2).ceil())
            .add(mod.View(5 * 4 * 4))
            .add(mod.Dropout(0.3))
            .add(mod.Linear(80, 3, with_bias=False))
            .add(mod.SoftMax()))


def _pair(name):
    """(reference module, port module, input shape)."""
    if name == "lenet":
        return jlenet.build(10), lenet.build(10, device="cpu"), (3, 28, 28, 1)
    if name == "vgg_cifar":
        return _reference_vgg(), vgg.build(10, device="cpu"), (2, 32, 32, 3)
    if name == "grouped_conv":
        return (jnn.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1, n_group=2),
                nn.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1, n_group=2),
                (2, 8, 8, 4))
    return _containers(jnn), _containers(nn), (2, 8, 8, 3)


@pytest.mark.parametrize("name", ["lenet", "vgg_cifar", "grouped_conv",
                                  "containers"])
def test_modules_byte_equal_and_load_across(tmp_path, name):
    jm, tm, shape = _pair(name)
    _carried(jm, tm)
    port, ref = str(tmp_path / "p.t7"), str(tmp_path / "r.t7")
    save_torch(tm, port)
    jtf.save_torch(jm, ref)
    assert open(port, "rb").read() == open(ref, "rb").read()
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = np.asarray(jm.evaluate_mode().forward(x))
    loaded = load_torch(ref, device="cpu").eval()
    assert next(loaded.parameters()).device.type == "cpu"
    with torch.no_grad():
        got = loaded(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FORWARD_ATOL
    back = jtf.load_torch(port)   # the reference reads the port's file
    for tree in ("parameter_tree", "buffer_tree"):
        got_tree = flatten_tree(getattr(back, tree)())
        want_tree = flatten_tree(getattr(jm, tree)())
        assert got_tree.keys() == want_tree.keys()
        for k in want_tree:
            assert np.array_equal(np.asarray(got_tree[k]),
                                  np.asarray(want_tree[k])), k
    with torch.no_grad():
        mine = tm.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(mine - want).max() <= FORWARD_ATOL
    save_torch(loaded, port)   # the loaded model writes the same file
    assert open(port, "rb").read() == open(ref, "rb").read()
    with pytest.raises(FileExistsError):
        save_torch(loaded, port, overwrite=False)


def test_conv_without_bias_and_torch_layouts():
    rng = np.random.default_rng(3)
    w4 = rng.normal(size=(8, 3, 5, 5))
    fields = {"nInputPlane": 3.0, "nOutputPlane": 8.0, "kW": 5.0, "kH": 5.0,
              "dW": 1.0, "dH": 1.0, "padW": 0.0, "padH": 0.0}
    mm = tf.from_torch_object(tf.TorchObject(
        "nn.SpatialConvolutionMM", dict(fields, weight=w4.reshape(8, -1),
                                        bias=np.zeros(8))))
    jmm = jtf.from_torch_object(jtf.TorchObject(
        "nn.SpatialConvolutionMM", dict(fields, weight=w4.reshape(8, -1),
                                        bias=np.zeros(8))))
    assert np.array_equal(mm.weight.detach().numpy(), np.asarray(jmm.weight))
    w5 = rng.normal(size=(2, 4, 2, 5, 5))   # BigDL's (G, O/g, I/g, kH, kW)
    grouped = tf.from_torch_object(tf.TorchObject(
        "nn.SpatialConvolution", dict(fields, nInputPlane=4.0, weight=w5)))
    assert grouped.n_group == 2 and grouped.weight.shape == (5, 5, 2, 8)
    no_bias = tf.from_torch_object(tf.TorchObject(
        "nn.SpatialConvolution", dict(fields, weight=w4)))
    # Torch's noBias(): no bias (the reference keeps a random one)
    assert not no_bias.with_bias
    assert "bias" not in dict(no_bias.named_parameters())
    thr = tf.from_torch_object(tf.TorchObject(
        "nn.Threshold", {"threshold": 0.5, "val": -1.0}))
    assert torch.equal(thr(torch.tensor([0.2, 0.7])),
                       torch.tensor([-1.0, 0.7]))


@pytest.mark.parametrize("name", ["inception_v1", "resnet50", "prelu",
                                  "torch_class"])
def test_unmapped_classes_are_refused_as_the_reference(name):
    if name == "torch_class":
        obj = tf.TorchObject("nn.SpatialCrossMapLRN", {})
        with pytest.raises(ValueError) as err:
            tf.from_torch_object(obj)
        with pytest.raises(ValueError) as jerr:
            jtf.from_torch_object(jtf.TorchObject("nn.SpatialCrossMapLRN",
                                                  {}))
        assert str(err.value) == str(jerr.value)
        with pytest.raises(ValueError, match="expected a torch nn object"):
            tf.from_torch_object({"not": "an object"})
        return
    port, ref = {
        "inception_v1": (lambda: inception.build(10, device="cpu"),
                         lambda: jinception.build(10)),
        "resnet50": (lambda: resnet.build(10, depth=50, device="cpu"),
                     None),
        "prelu": (lambda: nn.PReLU(), lambda: jnn.PReLU()),
    }[name]
    with pytest.raises(ValueError, match="no .t7 mapping") as err:
        tf.to_torch_object(port())
    if ref is not None:
        with pytest.raises(ValueError) as jerr:
            jtf.to_torch_object(ref())
        assert str(err.value) == str(jerr.value)
    else:
        assert "CAddTable" in str(err.value)


def test_load_torch_builds_on_the_card_unless_cpu_is_asked(tmp_path):
    p = str(tmp_path / "m.t7")
    save_torch(nn.Sequential().add(nn.Linear(3, 2)), p)
    assert isinstance(load_torch(p, as_module=False), tf.TorchObject)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_torch(p)
