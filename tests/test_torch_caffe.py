"""Caffe import and the prototxt parser in the port against the
reference's, on the CPU.

The test owns a caffemodel writer (protobuf wire format by hand: new
``LayerParameter`` and V1 ``V1LayerParameter`` layers, ``BlobShape`` or
legacy 4-D dims, packed float data, optionally split in pieces). Both
packages parse the same files to the same layers; a truncated file
raises; ``match_all`` refuses a model layer without weights, a
definition's weightless layer keeps its initial weights; a name-matched
parametric module with no mapping is refused; ``load_mean_file`` reads a
mean image. A LeNet and a small grouped-conv AlexNet-like net built in
both packages load one caffemodel and agree within 1e-5 on seeded images.
The port copies into its parameters in place, keeping their objects,
device and dtype. The prototxt grammar and its errors are the
reference's.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.interop import caffe as jcaffe
from bigdl_tpu.interop import prototxt as jpt
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import caffe, load_caffe, prototxt

FORWARD_ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- caffemodel writer

def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field, payload):
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _varint_field(field, value):
    return _varint(field << 3) + _varint(value)


def _blob(arr, legacy=False, pieces=1):
    arr = np.asarray(arr, "<f4")
    if legacy:
        dims = [1] * (4 - arr.ndim) + list(arr.shape)
        head = b"".join(_varint_field(f, d) for f, d in zip((1, 2, 3, 4),
                                                             dims))
    else:
        head = _len_field(7, _len_field(1, b"".join(_varint(d)
                                                    for d in arr.shape)))
    data = b"".join(_len_field(5, part.tobytes())
                    for part in np.array_split(arr.ravel(), pieces))
    return head + data


_V1 = {"Convolution": 4, "InnerProduct": 14, "Deconvolution": 39}


def write_caffemodel(path, layers, v1=False, legacy=False, pieces=1):
    """layers: [(name, type, [blobs])]."""
    out = b""
    for name, type_, blobs in layers:
        blob_bytes = [_blob(b, legacy, pieces) for b in blobs]
        if v1:
            body = (_len_field(4, name.encode())
                    + _varint_field(5, _V1[type_])
                    + b"".join(_len_field(6, b) for b in blob_bytes))
            out += _len_field(2, body)
        else:
            body = (_len_field(1, name.encode())
                    + _len_field(2, type_.encode())
                    + b"".join(_len_field(7, b) for b in blob_bytes))
            out += _len_field(100, body)
    with open(path, "wb") as f:
        f.write(out)


def _same_layers(got, ref):
    assert [(l.name, l.type) for l in got] == [(l.name, l.type) for l in ref]
    for g, r in zip(got, ref):
        assert len(g.blobs) == len(r.blobs)
        for a, b in zip(g.blobs, r.blobs):
            assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("v1,legacy,pieces", [
    (False, False, 1), (True, False, 1), (False, True, 1), (True, True, 1),
    (False, False, 3)])
def test_parse_formats_as_the_reference(tmp_path, v1, legacy, pieces):
    rng = np.random.default_rng(1)
    layers = [("conv1", "Convolution", [rng.normal(size=(4, 3, 3, 3)),
                                        rng.normal(size=(4,))]),
              ("ip1", "InnerProduct", [rng.normal(size=(10, 36)),
                                       rng.normal(size=(10,))])]
    p = str(tmp_path / "m.caffemodel")
    write_caffemodel(p, layers, v1=v1, legacy=legacy, pieces=pieces)
    got = caffe.parse_caffemodel(p)
    _same_layers(got, jcaffe.parse_caffemodel(p))
    assert got[0].type == "Convolution" and got[1].type == "InnerProduct"
    # legacy dims pad to four, leading 1s kept
    assert got[1].blobs[0].shape == ((1, 1, 10, 36) if legacy else (10, 36))
    assert got[0].blobs[0].shape == (4, 3, 3, 3)


def test_double_data_and_empty_blob(tmp_path):
    arr = np.arange(6, dtype="<f8")
    blob = (_len_field(7, _len_field(1, _varint(2) + _varint(3)))
            + _len_field(8, arr.tobytes()))
    body = (_len_field(1, b"d") + _len_field(2, b"Convolution")
            + _len_field(7, blob) + _len_field(7, b""))
    p = str(tmp_path / "d.caffemodel")
    with open(p, "wb") as f:
        f.write(_len_field(100, body))
    got = caffe.parse_caffemodel(p)
    _same_layers(got, jcaffe.parse_caffemodel(p))
    assert got[0].blobs[0].shape == (2, 3) and got[0].blobs[1].size == 0


def test_truncated_caffemodel_raises(tmp_path):
    p = str(tmp_path / "t.caffemodel")
    write_caffemodel(p, [("conv1", "Convolution",
                          [np.ones((4, 1, 3, 3), np.float32)])])
    data = open(p, "rb").read()
    open(p, "wb").write(data[:len(data) // 2])
    with pytest.raises(EOFError):
        caffe.parse_caffemodel(p)
    with pytest.raises(EOFError):
        jcaffe.parse_caffemodel(p)


def _small(mod, ip_name="ip1"):
    return (mod.Sequential()
            .add(mod.SpatialConvolution(1, 4, 3, 3).set_name("conv1"))
            .add(mod.ReLU())
            .add(mod.Reshape((4 * 6 * 6,)))
            .add(mod.Linear(4 * 6 * 6, 10).set_name(ip_name)))


def _conv_ip(tmp_path, rng):
    cw = rng.normal(size=(4, 1, 3, 3)).astype(np.float32)
    cb = rng.normal(size=(4,)).astype(np.float32)
    lw = rng.normal(size=(10, 144)).astype(np.float32)
    lb = rng.normal(size=(10,)).astype(np.float32)
    p = str(tmp_path / "net.caffemodel")
    write_caffemodel(p, [("conv1", "Convolution", [cw, cb]),
                         ("ip1", "InnerProduct", [lw, lb])])
    return p, (cw, cb, lw, lb)


def test_copies_in_place_keeping_objects_device_and_dtype(tmp_path):
    p, (cw, cb, lw, lb) = _conv_ip(tmp_path, np.random.default_rng(2))
    model = _small(nn).to(torch.bfloat16)
    conv, ip = model[0], model[3]
    before = {id(t) for t in model.parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    assert load_caffe(model, p) is model
    assert {id(t) for t in model.parameters()} == before
    assert all(t.dtype == torch.bfloat16 for t in model.parameters())
    assert opt.param_groups[0]["params"][0] is conv.weight
    want = torch.from_numpy(np.transpose(cw, (2, 3, 1, 0))).bfloat16()
    assert torch.equal(conv.weight.detach(), want)
    assert torch.equal(ip.weight.detach(), torch.from_numpy(lw).bfloat16())
    model32 = load_caffe(_small(nn), p)
    assert np.array_equal(model32[0].bias.detach().numpy(), cb)
    assert np.array_equal(model32[3].bias.detach().numpy(), lb)


def test_match_all_contract(tmp_path):
    p = str(tmp_path / "partial.caffemodel")
    write_caffemodel(p, [("conv1", "Convolution",
                          [np.ones((4, 1, 3, 3), np.float32)])])
    with pytest.raises(ValueError, match="missing weights for layers"
                                         r" \['ip1'\]"):
        load_caffe(_small(nn), p)
    with pytest.raises(ValueError, match="missing weights"):
        jcaffe.load_caffe(_small(jnn), p)
    model = _small(nn)
    keep = model[3].weight.detach().clone()
    load_caffe(model, p, match_all=False)
    assert torch.equal(model[3].weight.detach(), keep)


def test_definition_layers_keep_their_weights(tmp_path):
    rng = np.random.default_rng(3)
    cw = rng.normal(size=(4, 1, 3, 3)).astype(np.float32)
    d = tmp_path / "net.prototxt"
    d.write_text('layer { name: "conv1" type: "Convolution" }\n'
                 'layer { name: "ip1" type: "InnerProduct" }\n')
    m = str(tmp_path / "net.caffemodel")
    write_caffemodel(m, [("conv1", "Convolution", [cw])])
    model = _small(nn)
    keep = model[3].weight.detach().clone()
    load_caffe(model, str(d), m)
    assert torch.equal(model[3].weight.detach(), keep)
    assert np.array_equal(model[0].weight.detach().numpy(),
                          np.transpose(cw, (2, 3, 1, 0)))
    with pytest.raises(ValueError, match="missing weights"):
        load_caffe(_small(nn, ip_name="elsewhere"), str(d), m)
    with pytest.raises(TypeError, match="def_path"):
        load_caffe(model, "a", "b", "c")


def test_text_blobs_and_v1_enum_in_a_definition(tmp_path):
    p = tmp_path / "w.prototxt"
    p.write_text("""
    layer { name: "conv1" type: "Convolution"
            blobs { shape { dim: 2 dim: 2 } data: 1 data: 2 data: 3 data: 4 }
            blobs { num: 1 channels: 1 height: 1 width: 2 data: [5, 6] } }
    layers { name: "old" type: 14 }
    """)
    got = caffe.parse_prototxt_layers(str(p))
    _same_layers(got, jcaffe.parse_prototxt_layers(str(p)))
    assert np.array_equal(got[0].blobs[0], [[1, 2], [3, 4]])
    assert got[0].blobs[1].shape == (1, 1, 1, 2)
    assert got[1].type == "InnerProduct"


def test_batchnorm_scale_prelu_deconv_embed(tmp_path):
    rng = np.random.default_rng(4)
    mean, var = rng.normal(size=4), np.abs(rng.normal(size=4))
    gamma, beta, slopes = (rng.normal(size=4) for _ in range(3))
    dw, db = rng.normal(size=(3, 2, 3, 3)), rng.normal(size=2)
    ew = rng.normal(size=(7, 5))
    p = str(tmp_path / "b.caffemodel")
    write_caffemodel(p, [("bn1", "BatchNorm", [mean, var, [4.0]]),
                         ("scale1", "Scale", [gamma, beta]),
                         ("prelu1", "PReLU", [slopes]),
                         ("up1", "Deconvolution", [dw, db]),
                         ("embed1", "Embed", [ew])])

    def build(mod):
        return (mod.Sequential()
                .add(mod.SpatialBatchNormalization(4, affine=False)
                     .set_name("bn1"))
                .add(mod.Scale((4,)).set_name("scale1"))
                .add(mod.PReLU(4).set_name("prelu1")))
    model, ref = build(nn), build(jnn)
    load_caffe(model, p, match_all=False)
    jcaffe.load_caffe(ref, p, match_all=False)
    for got, want in (
            (model[0].running_mean, ref[0].running_mean),
            (model[0].running_var, ref[0].running_var),
            (model[1].cmul.weight, ref[1].cmul.weight),
            (model[1].cadd.bias, ref[1].cadd.bias),
            (model[2].weight, ref[2].weight)):
        assert np.array_equal(got.detach().numpy(), np.asarray(want))
    # the deconv blob is (I, O/g, kH, kW) = (3, 2, ...): a 4-in layer
    # cannot hold it (the reference rebinds the array without a check)
    with pytest.raises(ValueError, match="up1"):
        load_caffe(nn.Sequential().add(nn.SpatialFullConvolution(
            4, 2, 3, 3).set_name("up1")), p, match_all=False)
    deconv = nn.SpatialFullConvolution(3, 2, 3, 3).set_name("up1")
    jdeconv = jnn.SpatialFullConvolution(3, 2, 3, 3).set_name("up1")
    load_caffe(nn.Sequential().add(deconv), p, match_all=False)
    jcaffe.load_caffe(jnn.Sequential().add(jdeconv), p, match_all=False)
    assert np.array_equal(deconv.weight.detach().numpy(),
                          np.asarray(jdeconv.weight))
    assert np.array_equal(deconv.bias.detach().numpy(),
                          np.asarray(jdeconv.bias))
    embed = nn.LookupTable(7, 5).set_name("embed1")
    load_caffe(nn.Sequential().add(embed), p, match_all=False)
    assert np.array_equal(embed.weight.detach().numpy(),
                          ew.astype(np.float32))


def test_batchnorm_zero_scale_factor_and_embed_bias(tmp_path):
    p = str(tmp_path / "z.caffemodel")
    write_caffemodel(p, [("bn", "BatchNorm", [np.ones(2), np.ones(2), [0.0]]),
                         ("embed1", "Embed", [np.ones((7, 5)), np.ones(5)])])
    m = nn.Sequential().add(
        nn.SpatialBatchNormalization(2, affine=False).set_name("bn"))
    load_caffe(m, p, match_all=False)
    assert torch.equal(m[0].running_mean, torch.zeros(2))
    with pytest.raises(ValueError, match="bias blob"):
        load_caffe(nn.Sequential().add(
            nn.LookupTable(7, 5).set_name("embed1")), p, match_all=False)


@pytest.mark.parametrize("which", ["plain", "composite"])
def test_unmapped_parametric_module_is_refused(tmp_path, which):
    p = str(tmp_path / "u.caffemodel")
    write_caffemodel(p, [("odd1", "SomeCustom", [np.ones((3, 3))])])
    for mod, load in ((nn, load_caffe), (jnn, jcaffe.load_caffe)):
        odd = (mod.Bilinear(3, 3, 2) if which == "plain"
               else mod.Sequential().add(mod.Linear(4, 4)))
        with pytest.raises(ValueError, match="no weight mapping"):
            load(mod.Sequential().add(odd.set_name("odd1")), p,
                 match_all=False)


def test_load_mean_file(tmp_path):
    mean = np.arange(2 * 3 * 5, dtype=np.float32).reshape(3, 5, 2)
    for legacy, name in ((False, "m.binaryproto"), (True, "l.binaryproto")):
        p = tmp_path / name
        p.write_bytes(_blob(np.transpose(mean, (2, 0, 1)), legacy=legacy))
        got = caffe.load_mean_file(str(p))
        assert got.shape == (3, 5, 2) and np.array_equal(got, mean)
        assert np.array_equal(got, jcaffe.load_mean_file(str(p)))
    p = tmp_path / "flat.binaryproto"
    p.write_bytes(_blob(np.ones((4, 5))))
    with pytest.raises(ValueError, match="expected a"):
        caffe.load_mean_file(str(p))


# --------------------------------------------- whole nets in both packages

def _lenet(mod):
    return (mod.Sequential()
            .add(mod.SpatialConvolution(1, 6, 5, 5).set_name("conv1"))
            .add(mod.Tanh())
            .add(mod.SpatialMaxPooling(2, 2, 2, 2))
            .add(mod.SpatialConvolution(6, 12, 5, 5).set_name("conv2"))
            .add(mod.Tanh())
            .add(mod.SpatialMaxPooling(2, 2, 2, 2))
            .add(mod.Reshape((12 * 4 * 4,)))
            .add(mod.Linear(12 * 4 * 4, 100).set_name("ip1"))
            .add(mod.Tanh())
            .add(mod.Linear(100, 10).set_name("ip2"))
            .add(mod.LogSoftMax()))


def _alexnet_like(mod):
    return (mod.Sequential()
            .add(mod.SpatialConvolution(3, 8, 5, 5, 2, 2).set_name("conv1"))
            .add(mod.ReLU())
            .add(mod.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1"))
            .add(mod.SpatialMaxPooling(3, 3, 2, 2))
            .add(mod.SpatialConvolution(8, 12, 3, 3, 1, 1, 1, 1, n_group=2)
                 .set_name("conv2"))
            .add(mod.ReLU())
            .add(mod.SpatialMaxPooling(3, 3, 2, 2))
            .add(mod.Reshape((12 * 3 * 3,)))
            .add(mod.Linear(12 * 3 * 3, 16).set_name("fc6"))
            .add(mod.ReLU())
            .add(mod.Linear(16, 5).set_name("fc8"))
            .add(mod.LogSoftMax()))


def _caffe_blobs(model, rng):
    """One blob list a caffe layer would hold for each named parametric
    module of a port model: conv (O, I/g, kH, kW), linear (out, in)."""
    layers = []
    for m in model.modules():
        if isinstance(m, nn.SpatialConvolution):
            w = rng.normal(0, 0.2, (m.n_output_plane,
                                    m.n_input_plane // m.n_group,
                                    m.kernel_h, m.kernel_w))
            layers.append((m.get_name(), "Convolution",
                           [w, rng.normal(0, 0.1, m.n_output_plane)]))
        elif isinstance(m, nn.Linear):
            layers.append((m.get_name(), "InnerProduct",
                           [rng.normal(0, 0.2, (m.output_size, m.input_size)),
                            rng.normal(0, 0.1, m.output_size)]))
    return layers


@pytest.mark.parametrize("build,shape,v1", [
    (_lenet, (3, 28, 28, 1), False), (_lenet, (3, 28, 28, 1), True),
    (_alexnet_like, (2, 35, 35, 3), False)])
def test_nets_load_one_file_with_the_references_forward(tmp_path, build,
                                                        shape, v1):
    rng = np.random.default_rng(5)
    model, ref = build(nn), build(jnn)
    p = str(tmp_path / "net.caffemodel")
    write_caffemodel(p, _caffe_blobs(model, rng), v1=v1)
    load_caffe(model, p)
    jcaffe.load_caffe(ref, p)
    x = rng.normal(size=shape).astype(np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.evaluate_mode().forward(x))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FORWARD_ATOL


# ------------------------------------------------------------------ prototxt

DEPLOY = """
# LeNet-style deploy definition
name: "Le" "Net"        # adjacent strings concatenate
input: "data"
input_shape { dim: [1, 1, 28, 28] }
layer {
  name: "conv1"
  type: "Convolution"
  bottom: "data"; top: "conv1"
  convolution_param <
    num_output: 4
    kernel_size: 3
    weight_filler { type: "xavier" value: 1.5e-2 std: .5 }
  >
}
layer {
  name: 'ip1'
  type: "InnerProduct"
  inner_product_param: { num_output: 0x0A bias_term: true scale: -inf }
  param { lr_mult: 1 } param { lr_mult: 2 }
}
layers { name: "old" type: CONVOLUTION description: "a\\tb\\"c" }
"""


def test_prototxt_grammar_as_the_reference(tmp_path):
    net = prototxt.parse(DEPLOY)
    assert net == jpt.parse(DEPLOY)
    assert prototxt.first(net, "name") == "LeNet"
    assert net["input_shape"][0]["dim"] == [1, 1, 28, 28]
    conv, ip = net["layer"]
    cp = prototxt.first(conv, "convolution_param")
    assert prototxt.first(prototxt.first(cp, "weight_filler"), "std") == 0.5
    ipp = prototxt.first(ip, "inner_product_param")
    assert ipp["num_output"] == [10] and ipp["bias_term"] == [True]
    assert ipp["scale"] == [float("-inf")]
    assert [prototxt.first(q, "lr_mult") for q in ip["param"]] == [1, 2]
    assert prototxt.first(net["layers"][0], "type") == "CONVOLUTION"
    assert prototxt.first(net["layers"][0], "description") == 'a\tb"c'
    assert prototxt.first(net, "missing", 7) == 7
    f = tmp_path / "d.prototxt"
    f.write_text(DEPLOY)
    assert prototxt.parse_file(str(f)) == net


@pytest.mark.parametrize("text", [
    "layer { name: 'x' ",        # unclosed message
    "name 'x'",                  # missing colon
    "name: }",                   # a value that is punctuation
    "name: \"x\" @",             # a character outside the grammar
    ": 3",                       # no field name
    "a: [1, 2",                  # unclosed list
])
def test_prototxt_errors_as_the_reference(text):
    with pytest.raises(prototxt.PrototxtError):
        prototxt.parse(text)
    with pytest.raises(jpt.PrototxtError):
        jpt.parse(text)
