"""The port's module surface against the JAX package's, on the CPU: the
instance methods of ``bigdl_tpu/nn/module.py`` (the parameter and buffer
trees and their loads, ``get_parameters``' flat view, ``output`` /
``grad_input``, ``backward(input, grad_output)``, ``predict``, the mode
switches, ``find_module``, ``apply_to_modules``, ``clone_module``,
``reset``, ``zero_grad_parameters``, ``summary``) on ``Linear``,
``Sequential``, ``Graph``, ``BatchNormalization`` and
``MultiHeadAttention``. The reference's ``parameter_tree()`` goes into the
port as numpy through ``load_parameter_tree``; inputs are numpy from a
seed. Flat vectors and summaries are equal; gradients and forwards agree
within 1e-5 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import module as port_module
from bigdl_tpu_torch.utils.rng import RandomGenerator as PortRNG

RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One thread; and the global generators the test draws from (both
    packages' ``RandomGenerator`` and PyTorch's) left as it found them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    gens = [JaxRNG.RNG(), PortRNG.RNG()]
    saved = [(g._seed, g._np.bit_generator.state, getattr(g, "_key", None))
             for g in gens]
    torch_state = torch.get_rng_state()
    yield
    for g, (seed, state, key) in zip(gens, saved):
        g._seed, g._np.bit_generator.state = seed, state
        if key is not None:
            g._key = key
    torch.set_rng_state(torch_state)
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, ref, tol=RTOL, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, (what, err)


def _carry(jm, tm):
    """The reference's trees into the port module, as numpy."""
    tm.load_parameter_tree(_np(jm.parameter_tree()))
    tm.load_buffer_tree(_np(jm.buffer_tree()))
    return tm


def _graph(pkg):
    x = pkg.Input().inputs()
    h = pkg.Linear(6, 5).inputs(x)
    a = pkg.Tanh().inputs(h)
    b = pkg.Linear(5, 5).inputs(h)
    out = pkg.CAddTable().inputs(a, b)
    return pkg.Graph(x, pkg.Linear(5, 3).inputs(out))


def _seq12(pkg):
    m = pkg.Sequential()
    for i in range(12):
        m.add(pkg.Linear(6, 6))
        if i == 4:
            m.add(pkg.ReLU())
    return m


def _bn(pkg):
    return pkg.Sequential().add(pkg.Linear(6, 4)) \
        .add(pkg.BatchNormalization(4)).add(pkg.ReLU())


def _mha(pkg):
    return pkg.MultiHeadAttention(8, 2, causal=True)


#: name -> (constructor over a package, input shape)
CASES = {
    "linear": (lambda p: p.Linear(6, 3), (4, 6)),
    "sequential12": (_seq12, (4, 6)),
    "graph": (_graph, (4, 6)),
    "batchnorm": (_bn, (5, 6)),
    "mha": (_mha, (2, 5, 8)),
}


def _pair(name):
    build, shape = CASES[name]
    jm, tm = build(jnn), build(nn)
    return jm, _carry(jm, tm), shape


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_trees_round_trip_under_the_reference_keys(name):
    jm, tm, _ = _pair(name)
    for jt, tt in ((jm.parameter_tree(), tm.parameter_tree()),
                   (jm.buffer_tree(), tm.buffer_tree())):
        want = [(p, np.asarray(v)) for p, v in _leaves(jt)]
        got = [(p, v.detach().numpy()) for p, v in _leaves(
            jax.tree_util.tree_map(lambda t: t, tt))]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(p))
    # the leaves are the live tensors
    live = {id(p) for p in tm.parameters()}
    assert all(id(t) in live for _, t in _leaves(tm.parameter_tree()))


def test_load_refuses_a_wrong_shape_and_writes_nothing():
    jm, tm, _ = _pair("sequential12")
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    bad = _np(jm.parameter_tree())
    bad["0"]["weight"] = bad["0"]["weight"] + 1.0   # would load first
    bad["7"]["bias"] = np.zeros((7,), np.float32)   # wrong shape
    with pytest.raises(ValueError, match="7.bias"):
        tm.load_parameter_tree(bad)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    # a partial tree loads only its keys, in place
    ptr = tm.get_submodule("3").weight.data_ptr()
    tm.load_parameter_tree({"3": {"weight": np.ones((6, 6), np.float32)}})
    assert tm.get_submodule("3").weight.data_ptr() == ptr
    assert torch.equal(tm.get_submodule("3").weight, torch.ones(6, 6))
    assert torch.equal(tm.get_submodule("4").weight, before["4.weight"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_get_parameters_equals_the_reference_flat_vector(name):
    jm, tm, _ = _pair(name)
    jflat, junravel = jm.get_parameters()
    flat, unravel = tm.get_parameters()
    assert flat.dtype == torch.float32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert tm.n_parameters() == jm.n_parameters() == flat.numel()
    back = unravel(flat)
    for (p, g), (_, w) in zip(_leaves(back), _leaves(tm.parameter_tree())):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w.detach()), p
    # flat is a copy, not a view
    before = flat.clone()
    flat += 1
    assert torch.equal(tm.get_parameters()[0], before)


def test_get_parameters_takes_the_string_order_and_promotes():
    tm = _seq12(nn)
    flat, _ = tm.get_parameters()
    # JAX's order: child "10" before "2"
    order = [str(k) for k in sorted(str(i) for i in range(13))]
    assert order.index("10") < order.index("2")
    linears = [tm.get_submodule(k) for k in order if k != "5"]
    want = torch.cat([t.detach().reshape(-1) for m in linears
                      for t in (m.bias, m.weight)])
    assert torch.equal(flat, want)
    mixed = nn.Sequential().add(nn.Linear(3, 2)).add(nn.Linear(2, 2))
    mixed.get_submodule("0").to(torch.bfloat16)
    flat, unravel = mixed.get_parameters()
    assert flat.dtype == torch.float32
    back = unravel(flat)
    assert back["0"]["weight"].dtype == torch.bfloat16
    assert torch.equal(back["0"]["weight"], mixed.get_submodule("0").weight)


@pytest.mark.parametrize("name,train", [
    ("linear", False), ("sequential12", False), ("graph", False),
    ("batchnorm", True), ("batchnorm", False), ("mha", False)])
def test_backward_matches_the_reference(name, train):
    jm, tm, shape = _pair(name)
    if not train:
        jm.evaluate_mode()
        tm.evaluate_mode()
    x = _x(shape, seed=3)
    out_shape = tuple(np.asarray(jm.forward(jnp.asarray(x))).shape)
    g = _x(out_shape, seed=4)
    want = np.asarray(jm.backward(jnp.asarray(x), jnp.asarray(g)))
    bufs = {k: v.clone() for k, v in tm.named_buffers()}
    got = tm.backward(torch.from_numpy(x), torch.from_numpy(g))
    _close(got, want, what=name)
    assert tm.grad_input is got
    assert tm.output is None
    assert all(p.grad is None for p in tm.parameters())
    for k, v in tm.named_buffers():
        assert torch.equal(v, bufs[k]), k


def test_backward_leaves_gradients_and_takes_tables():
    tm = nn.CAddTable()
    x = [torch.ones(2, 3), torch.full((2, 3), 2.0)]
    gi = tm.backward(x, torch.full((2, 3), 0.5))
    assert isinstance(gi, list) and len(gi) == 2
    assert all(torch.equal(t, torch.full((2, 3), 0.5)) for t in gi)
    lin = nn.Linear(3, 2)
    lin.weight.grad = torch.full_like(lin.weight, 7.0)
    lin.backward(torch.ones(4, 3), torch.ones(4, 2))
    assert torch.equal(lin.weight.grad, torch.full_like(lin.weight, 7.0))
    table = nn.LookupTable(5, 3)
    with pytest.raises(TypeError, match="LookupTable"):
        table.backward(torch.tensor([[1, 2]]), torch.ones(1, 2, 3))


def test_output_is_recorded_and_cleared():
    tm = _bn(nn)
    x = torch.from_numpy(_x((5, 6)))
    y = tm(x)
    assert tm.output is y
    assert tm.get_submodule("0").output is not None
    with port_module.record_outputs(False):
        tm(x)
    assert tm.output is y
    tm.backward(x, torch.ones_like(y))
    assert all(m.output is None for m in tm.modules())
    assert tm.grad_input.shape == x.shape
    tm(x)
    tm.predict(x.numpy())
    assert all(m.output is None and m.grad_input is None
               for m in tm.modules())
    # a recorded output does not go with a copy
    tm(x)
    assert tm.clone_module().output is None


@pytest.mark.parametrize("name", ["linear", "mha", "batchnorm"])
def test_predict_matches_the_reference(name):
    jm, tm, shape = _pair(name)
    x = _x(shape, seed=5)
    tm.training_mode()
    got = tm.predict(x)
    assert tm.is_training()
    _close(got, np.asarray(jm.predict(jnp.asarray(x))), what=name)


def test_predict_class_and_the_device_rule():
    tm = nn.Linear(6, 4)
    x = _x((3, 6), seed=6)
    out = tm.predict(x)
    assert torch.equal(tm.predict_class(x), out.argmax(-1) + 1)
    # no state: the input tensor's device, and numpy goes to the card
    act = nn.Tanh()
    assert act.predict(torch.zeros(2)).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            act.predict(np.zeros(2, np.float32))


def test_mode_switches_propagate():
    tm = _bn(nn)
    assert tm.evaluate_mode() is tm
    assert not any(m.training for m in tm.modules())
    assert tm.training_mode() is tm
    assert all(m.is_training() for m in tm.modules())
    assert tm.set_training(False) is tm and not tm.get_submodule("1").training
    assert tm.set_training() is tm and tm.get_submodule("1").training


def test_find_module_and_apply_to_modules():
    jm = jnn.Sequential().add(jnn.Linear(2, 3).set_name("fc1")) \
        .add(jnn.Sequential().add(jnn.Linear(3, 3).set_name("deep")))
    tm = nn.Sequential().add(nn.Linear(2, 3).set_name("fc1")) \
        .add(nn.Sequential().add(nn.Linear(3, 3).set_name("deep")))
    assert tm.find_module("deep") is tm.get_submodule("1.0")
    assert tm.find_module("missing") is None
    assert jm.find_module("deep").name == tm.find_module("deep").name
    seen = []
    assert tm.apply_to_modules(lambda m: seen.append(m.name)) is tm
    want = []
    jm.apply_to_modules(lambda m: want.append(m.name))
    assert seen == want


def test_clone_module_is_independent():
    tm = _carry(*(_pair("mha")[:2]))
    tm.__dict__["_prefix_trie"] = {"cache": object()}
    clone = tm.clone_module()
    assert "_prefix_trie" not in clone.__dict__
    x = torch.from_numpy(_x((2, 5, 8), seed=7))
    assert torch.equal(clone(x), tm(x))
    ptrs = {p.data_ptr() for p in tm.parameters()}
    assert not ptrs & {p.data_ptr() for p in clone.parameters()}
    with torch.no_grad():
        clone.in_proj_weight.add_(1.0)
    assert not torch.equal(clone(x), tm(x))


def test_reset_draws_within_the_reference_bounds():
    lin = nn.Linear(50, 40)
    ptr, old = lin.weight.data_ptr(), lin.weight.detach().clone()
    torch.manual_seed(3)
    lin.reset()
    assert lin.weight.data_ptr() == ptr
    assert not torch.equal(lin.weight, old)
    jl = jnn.Linear(50, 40)
    jl.reset()
    bound = 1.0 / np.sqrt(50)
    for w in (lin.weight.detach().numpy(), lin.bias.detach().numpy(),
              np.asarray(jl.weight)):
        assert np.abs(w).max() <= bound
        assert np.abs(w).max() > 0.9 * bound
    conv = nn.SpatialConvolution(3, 8, 3, 3)
    torch.manual_seed(4)
    conv.reset()
    jc = jnn.SpatialConvolution(3, 8, 3, 3)
    jc.reset()
    assert np.abs(conv.weight.detach().numpy()).max() <= 1 / np.sqrt(27)
    assert np.abs(np.asarray(jc.weight)).max() <= 1 / np.sqrt(27)
    # a container resets its children; a quantized twin refuses
    seq = nn.Sequential().add(nn.Linear(4, 4)).add(nn.ReLU())
    before = seq.get_submodule("0").weight.detach().clone()
    seq.reset()
    assert not torch.equal(seq.get_submodule("0").weight, before)
    from bigdl_tpu_torch.nn.quantized import quantize_model
    q = quantize_model(nn.Sequential().add(nn.Linear(4, 4)), device="cpu")
    with pytest.raises(RuntimeError, match="inference-only"):
        q.reset()


def test_zero_grad_parameters_drops_the_gradients():
    tm = nn.Linear(3, 2)
    tm(torch.ones(1, 3)).sum().backward()
    assert tm.weight.grad is not None
    assert tm.zero_grad_parameters() is None
    assert tm.weight.grad is None and tm.bias.grad is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_summary_equals_the_reference(name):
    jm, tm, _ = _pair(name)
    for depth in (0, 1, 2, 3):
        assert tm.summary(depth) == jm.summary(depth), depth
    assert tm.functional_state()[0].keys() == jm.parameter_tree().keys()


def test_backward_timing_counts_once():
    tm = nn.Sequential().add(nn.Linear(3, 3)).add(nn.Tanh())
    port_module.enable_timing(True)
    try:
        tm.reset_times()
        tm.backward(torch.ones(2, 3), torch.ones(2, 3))
        times = {id(m): (f, b) for m, f, b in tm.get_times()}
    finally:
        port_module.enable_timing(False)
    f, b = times[id(tm)]
    assert f == 0.0 and b > 0.0
    assert all(times[id(m)] == (0.0, 0.0) for m in tm.children())
