"""``tensor/tensor.py`` in the port against the JAX package's ``Tensor``,
on the CPU: the same 1-based calls on the same seeded data give the same
values (exactly, or within 1e-6 relative for sums and products in f32).
Where the two differ by design, views: the port's ``select``, ``narrow``,
``transpose``, ``split`` and ``storage()`` share memory with their source
as Torch's do, so a write through a view is checked against numpy's view
semantics (the reference's arrays are immutable and its views copies)."""

import numpy as np
import pytest
import torch

from bigdl_tpu.tensor import Tensor as JTensor
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.tensor import Storage, Tensor
from bigdl_tpu_torch.utils.rng import RandomGenerator

RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _pair(shape, seed=0, dtype=np.float32):
    a = _data(shape, seed, dtype)
    return Tensor(a, device="cpu"), JTensor(a)


def _eq(got, want, rtol=0.0):
    g = got.numpy() if isinstance(got, Tensor) else np.asarray(got)
    w = want.numpy() if isinstance(want, JTensor) else np.asarray(want)
    assert g.shape == w.shape
    if rtol:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max())
    else:
        np.testing.assert_array_equal(g, w)


def test_construction_and_structure():
    t, j = Tensor(2, 3, device="cpu"), JTensor(2, 3)
    assert t.size() == j.size() == (2, 3) and t.size(2) == j.size(2) == 3
    assert t.dim() == t.n_dimension() == 2 and t.n_element() == 6
    assert Tensor(device="cpu").size() == JTensor().size() == (0,)
    _eq(Tensor([[1, 2], [3, 4]], device="cpu"), JTensor([[1, 2], [3, 4]]))
    ints = np.arange(4, dtype=np.int64)
    assert Tensor(ints, device="cpu").numpy().dtype == np.int64
    _eq(Tensor.range(1, 4, device="cpu"), JTensor.range(1, 4))
    _eq(Tensor.ones(2, 2, device="cpu"), JTensor.ones(2, 2))
    _eq(Tensor.zeros(3, device="cpu"), JTensor.zeros(3))
    with pytest.raises(IndexError):
        t.size(3)
    with pytest.raises(TypeError):
        Tensor(2.5, device="cpu")


@pytest.mark.parametrize("op", ["select", "narrow", "transpose", "t", "view",
                                "squeeze", "unsqueeze", "expand",
                                "repeat_tensor", "index_select",
                                "masked_select", "getitem"])
def test_indexing_matches_reference(op):
    t, j = _pair((3, 1, 4))
    t2, j2 = _pair((3, 4), 1)
    calls = {
        "select": lambda x, y: x.select(3, 2),
        "narrow": lambda x, y: x.narrow(3, 2, 2),
        "transpose": lambda x, y: x.transpose(1, 3),
        "t": lambda x, y: y.t(),
        "view": lambda x, y: x.view(4, 3),
        "squeeze": lambda x, y: x.squeeze(2),
        "unsqueeze": lambda x, y: x.unsqueeze(1),
        "expand": lambda x, y: x.expand(3, 5, 4),
        "repeat_tensor": lambda x, y: y.repeat_tensor(2, 1),
        "index_select": lambda x, y: y.index_select(2, np.array([4, 1, 1])),
        "masked_select": lambda x, y: y.masked_select(
            np.asarray(y.numpy() if hasattr(y, "numpy") else y.data) > 0),
        "getitem": lambda x, y: y[2]}
    _eq(calls[op](t, t2), calls[op](j, j2))
    assert t2[2, 3] == j2[2, 3]
    with pytest.raises(IndexError):
        t.select(1, 4)
    with pytest.raises(IndexError):
        t2.index_select(1, np.array([0]))


def test_views_share_storage():
    a = _data((3, 4))
    t = Tensor(a, device="cpu")
    want = a.copy()
    t.select(1, 2).fill(7.0)
    want[1, :] = 7.0
    t.narrow(2, 3, 2).mul(2.0)
    want[:, 2:4] *= 2.0
    t.t().select(1, 1).zero()
    want[:, 0] = 0.0
    t[3].add(1.0)
    want[2] += 1.0
    for piece in t.split(2, 1):
        piece.add(0.5)
    want += 0.5
    _eq(t, want)
    s = t.storage()
    assert isinstance(s, Storage) and len(s) == 12
    s[2] = -1.0
    want[0, 1] = -1.0
    _eq(t, want)
    assert t.stride() == (4, 1) and t.t().stride() == (1, 4)
    assert not t.t().is_contiguous() and t.t().contiguous().is_contiguous()


def test_mutation_matches_reference():
    t, j = _pair((2, 3))
    for x in (t, j):
        assert x.fill(2.0) is x
        x.add(1.0).mul(3.0).sub(2.0).div(2.0)
        x.add(2.0, Tensor.ones(2, 3, device="cpu") if isinstance(x, Tensor)
              else JTensor.ones(2, 3))
        x.set_value(1, 2, -4.0)
        x.cinv()
    _eq(t, j, RTOL)
    src = _data((6,), 2)
    _eq(t.copy(src), j.copy(src))
    _eq(t.resize(4, 2), j.resize(4, 2))
    _eq(t.resize(2), j.resize(2))
    t.zero()
    j.zero()
    _eq(t, j)
    _eq(t.apply1(lambda v: v + 3), j.apply1(lambda v: v + 3))
    with pytest.raises(ValueError):
        t.copy(np.zeros(5))


@pytest.mark.parametrize("op", ["pow", "sqrt", "abs", "log", "log1p", "exp",
                                "cmul", "cdiv", "cadd"])
def test_elementwise_matches_reference(op):
    a = np.abs(_data((3, 4))) + 0.5
    b = _data((3, 4), 1)
    t, j = Tensor(a, device="cpu"), JTensor(a)
    args = {"pow": (2.5,), "cmul": (b,), "cdiv": (b,), "cadd": (0.5, b)}
    getattr(t, op)(*args.get(op, ()))
    getattr(j, op)(*args.get(op, ()))
    _eq(t, j, RTOL)


def test_reductions_match_reference():
    t, j = _pair((3, 5))
    assert t.sum() == pytest.approx(j.sum(), rel=RTOL)
    assert t.mean() == pytest.approx(j.mean(), rel=RTOL)
    assert t.max() == j.max() and t.min() == j.min()
    for d in (1, 2):
        _eq(t.sum(d), j.sum(d), RTOL)
        _eq(t.mean(d), j.mean(d), RTOL)
        for f in ("max", "min"):
            (gv, gi), (wv, wi) = getattr(t, f)(d), getattr(j, f)(d)
            _eq(gv, wv)
            _eq(gi, wi)
            assert gi.numpy().dtype == np.int32
    for p in (1, 2, 3):
        assert t.norm(p) == pytest.approx(j.norm(p), rel=RTOL)
    u, k = _pair((15,), 2)
    assert t.view(15).dot(u) == pytest.approx(j.view(15).dot(k), rel=RTOL)


def test_products_match_reference():
    a, b, c = _data((3, 4)), _data((4, 2), 1), _data((3, 2), 2)
    v, w = _data((4,), 3), _data((3,), 4)
    pairs = [(Tensor(2, 2, device="cpu"), JTensor(2, 2))]
    for t, j in pairs:
        _eq(t.mm(a, b), j.mm(a, b), RTOL)
        _eq(t.mv(a, v), j.mv(a, v), RTOL)
        _eq(Tensor(c, device="cpu").addmm(0.5, c, 2.0, a, b),
            JTensor(c).addmm(0.5, c, 2.0, a, b), RTOL)
        _eq(Tensor(c, device="cpu").addmm(a, b), JTensor(c).addmm(a, b), RTOL)
        _eq(Tensor(c, device="cpu").addmm(0.5, a, b),
            JTensor(c).addmm(0.5, a, b), RTOL)
        _eq(Tensor(w, device="cpu").addmv(0.5, 2.0, a, v),
            JTensor(w).addmv(0.5, 2.0, a, v), RTOL)
        _eq(Tensor(a, device="cpu").addr(1.5, w, v),
            JTensor(a).addr(1.5, w, v), RTOL)
        x, y = _data((2, 3, 4), 5), _data((2, 4, 2), 6)
        _eq(t.bmm(x, y), j.bmm(x, y), RTOL)
    with pytest.raises(TypeError):
        Tensor(c, device="cpu").addmm(1.0, c, 2.0, 3.0, a, b)


def test_sort_topk_gather_scatter_match_reference():
    a = np.round(_data((3, 6)), 1)   # ties
    t, j = Tensor(a, device="cpu"), JTensor(a)
    for desc in (False, True):
        for d in (None, 1, 2):
            (gv, gi), (wv, wi) = t.sort(d, desc), j.sort(d, desc)
            _eq(gv, wv)
            _eq(gi, wi)
    for k, inc in ((1, True), (3, False), (6, True)):
        (gv, gi), (wv, wi) = t.topk(k, 2, inc), j.topk(k, 2, inc)
        _eq(gv, wv)
        _eq(gi, wi)
    (gv, gi), (wv, wi) = t.kthvalue(2, 2), j.kthvalue(2, 2)
    _eq(gv, wv)
    _eq(gi, wi)
    idx = np.random.default_rng(1).integers(1, 7, (3, 4))
    _eq(t.gather(2, idx), j.gather(2, idx))
    src = _data((3, 4), 2)
    _eq(Tensor(a, device="cpu").scatter(2, idx[:, :1].repeat(4, 1), src),
        JTensor(a).scatter(2, idx[:, :1].repeat(4, 1), src))
    with pytest.raises(IndexError):
        t.gather(2, np.zeros((3, 1), np.int64))
    with pytest.raises(IndexError):
        t.topk(7, 2)


def test_split_chunk_conv_match_reference():
    t, j = _pair((7, 3))
    for f, arg in (("split", 3), ("chunk", 3)):
        got, want = getattr(t, f)(arg, 1), getattr(j, f)(arg, 1)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
    img, ker = _pair((6, 5), 3)[0], _data((3, 2), 4)
    jimg = JTensor(img.numpy())
    for kind in ("V", "F"):
        _eq(img.conv2(ker, kind), jimg.conv2(ker, kind), 1e-5)
        _eq(img.xcorr2(ker, kind), jimg.xcorr2(ker, kind), 1e-5)
    with pytest.raises(ValueError):
        img.conv2(ker, "S")


def test_operators_equality_and_clone():
    t, j = _pair((2, 3))
    u, k = _pair((2, 3), 1)
    for f in (lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y,
              lambda x, y: x / y, lambda x, y: -x, lambda x, y: 2.0 - x,
              lambda x, y: 3.0 * x, lambda x, y: x + 1.5):
        _eq(f(t, u), f(j, k), RTOL)
    c = t.clone()
    assert c == t and c is not t and c.almost_equal(t)
    c.add(1.0)
    assert not (c == t) and not c.almost_equal(t)
    assert t.is_same_size_as(u)
    st = t.storage()
    assert [st[i] for i in (1, 6)] == [j.storage()[i] for i in (1, 6)]
    with pytest.raises(IndexError):
        st[7]
    c.set_storage(Storage(np.arange(6, dtype=np.float32)))
    _eq(c, np.arange(6, dtype=np.float32).reshape(2, 3))


def test_random_fills_draw_the_reference_stream():
    RandomGenerator.RNG().set_seed(5)
    JaxRNG.RNG().set_seed(5)
    t, j = Tensor(3, 4, device="cpu"), JTensor(3, 4)
    for f, args in (("uniform", (-1.0, 2.0)), ("rand", ()), ("randn", ()),
                    ("bernoulli", (0.3,))):
        getattr(t, f)(*args)
        getattr(j, f)(*args)
        _eq(t, j)


def test_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tensor(2, 2)
    wrapped = Tensor(torch.zeros(2))   # a given tensor stays where it lies
    assert wrapped.data.device.type == "cpu"
