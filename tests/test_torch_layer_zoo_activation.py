"""The layer zoo's activations and module surface in the port against the
JAX package's, on the CPU.

Every activation of ``bigdl_tpu/nn/activation.py`` is built in both
packages with the same arguments; the same numpy inputs (from a seed) go
through both; the forward, the input gradient and the parameter gradients
(one random cotangent, ``jax.vjp`` of the reference's ``functional_apply``
against autograd) agree within 1e-6 of max|ref| in f32. ``RReLU`` is
compared in eval mode; in training its slopes are checked for their range
and for a seed reproducing them. Also: ``TensorModule``,
``enable_timing`` / ``get_times`` / ``reset_times`` (every module listed,
non-negative times, a container's at least its children's, nothing
recorded with timing off) and the per-parameter regularizers
(``register_parameter``'s third argument, ``regularizer_tree``) against
the reference's trees. The shape layers: ``test_torch_layer_zoo_shape.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.utils.rng import RandomGenerator as PortRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state
from bigdl_tpu_torch.nn import module as module_mod
from bigdl_tpu_torch.utils import rng as trng

TOL = 1e-6

@pytest.fixture(autouse=True)
def one_thread():
    """One thread; and the global generators the test draws from (both
    packages' ``RandomGenerator`` and PyTorch's) left as it found them, so
    that no later test in the process sees other draws."""
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


def _x(shape, seed=0, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) * scale + shift).astype(np.float32)


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not got.size:
        return
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, (what, err)


def _items(out):
    """A module output (a tensor, a reference Table, a list) as a list."""
    if isinstance(out, dict):
        return [out[i] for i in range(1, len(out) + 1)]
    if isinstance(out, (list, tuple)):
        return list(out)
    return [out]


def _parity(jm, tm, inputs, tol, table=False, seed=1, train=False):
    """Forward, input gradients and parameter gradients of the reference
    module ``jm`` and the port module ``tm`` (the reference's weights and
    buffers carried in) on the numpy ``inputs``, one random cotangent.
    ``table``: the inputs form one table argument."""
    import_tree_state(tm, flatten_tree(jm.parameter_tree()),
                      flatten_tree(jm.buffer_tree()))
    tm.train(train)
    params, buffers = jm.parameter_tree(), jm.buffer_tree()
    xs = [jnp.asarray(a) for a in inputs]
    fl = [i for i, a in enumerate(inputs)
          if np.issubdtype(np.asarray(a).dtype, np.floating)]

    def f(p, *fx):
        args = list(xs)
        for i, v in zip(fl, fx):
            args[i] = v
        call = (JT(*args),) if table else tuple(args)
        out, _ = functional_apply(jm, p, buffers, *call, training=train)
        return out

    ref, vjp = jax.vjp(f, params, *[xs[i] for i in fl])
    refs = [np.asarray(r) for r in _items(ref)]
    rng = np.random.default_rng(seed)
    cots = [rng.normal(0, 1, r.shape).astype(np.float32) for r in refs]
    cot = (JT(*map(jnp.asarray, cots)) if isinstance(ref, dict)
           else [jnp.asarray(c) for c in cots] if isinstance(ref, (list, tuple))
           else jnp.asarray(cots[0]))
    ref_grads = vjp(cot)
    tx = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in fl:
        tx[i].requires_grad_()
    out = tm(tx) if table else tm(*tx)
    outs = _items(out)
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        _close(o.detach().numpy(), r, tol, "forward")
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(outs, cots) if o.requires_grad)
    if not torch.is_tensor(loss):
        return
    loss.backward()
    for k, i in enumerate(fl):
        g = tx[i].grad
        g = torch.zeros_like(tx[i]) if g is None else g
        _close(g.numpy(), np.asarray(ref_grads[1 + k]), tol, f"d input {i}")
    want = flatten_tree(ref_grads[0])
    for name, p in tm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close(g.numpy(), want[name], tol, f"d {name}")


# ---------------------------------------------------------------- activations
# (class name, constructor args, input shift, input scale): positive inputs
# where the function needs them (Sqrt, Log, Power)
ACTIVATIONS = [
    ("ReLU", (), 0.0, 1.0), ("ReLU6", (), 3.0, 4.0),
    ("Threshold", (0.2, -0.5), 0.0, 1.0), ("PReLU", (0,), 0.0, 1.0),
    ("PReLU", (5,), 0.0, 1.0), ("LeakyReLU", (0.1,), 0.0, 1.0),
    ("ELU", (0.7,), 0.0, 1.0), ("Sigmoid", (), 0.0, 2.0),
    ("LogSigmoid", (), 0.0, 2.0), ("Tanh", (), 0.0, 1.0),
    ("TanhShrink", (), 0.0, 1.0), ("HardTanh", (-0.5, 0.7), 0.0, 1.0),
    ("HardShrink", (0.4,), 0.0, 1.0), ("SoftShrink", (0.4,), 0.0, 1.0),
    ("SoftPlus", (1.5,), 0.0, 5.0), ("SoftSign", (), 0.0, 1.0),
    ("SoftMax", (), 0.0, 2.0), ("SoftMin", (), 0.0, 2.0),
    ("LogSoftMax", (), 0.0, 2.0), ("Clamp", (-0.3, 0.6), 0.0, 1.0),
    ("Power", (2.5, 0.5, 2.0), 0.0, 0.5), ("Power", (2, 1.5, -0.2), 0.0, 1.0),
    ("Sqrt", (), 3.0, 0.5), ("Square", (), 0.0, 1.0), ("Abs", (), 0.0, 1.0),
    ("Log", (), 3.0, 0.5), ("Exp", (), 0.0, 1.0),
    ("AddConstant", (1.25,), 0.0, 1.0), ("MulConstant", (-0.75,), 0.0, 1.0),
    ("GradientReversal", (0.3,), 0.0, 1.0), ("RReLU", (0.1, 0.3), 0.0, 1.0),
]


@pytest.mark.parametrize("name,args,shift,scale", ACTIVATIONS,
                         ids=[f"{a[0]}{i}" for i, a in enumerate(ACTIVATIONS)])
def test_activation_matches_reference(name, args, shift, scale):
    jm, tm = getattr(jnn, name)(*args), getattr(nn, name)(*args)
    jm.evaluate_mode()
    _parity(jm, tm, [_x((3, 4, 5), 2, scale, shift)], TOL)


def test_every_reference_activation_is_covered():
    import bigdl_tpu.nn.activation as ref
    names = {n for n, v in vars(ref).items()
             if isinstance(v, type) and v.__module__ == ref.__name__}
    assert names <= {a[0] for a in ACTIVATIONS}, names - {a[0] for a in
                                                          ACTIVATIONS}


def test_inplace_flags_take_the_reference_positions():
    assert nn.ReLU(True)(torch.tensor([-1.0, 2.0])).tolist() == [0.0, 2.0]
    assert nn.Threshold(0.5, 9.0, True).v == 9.0
    assert nn.AddConstant(2.0, True).constant_scalar == 2.0


def test_rrelu_training_slopes_range_and_seed():
    x = -torch.ones(4000)
    m = nn.RReLU(0.1, 0.3)
    y = m(x)
    slopes = -y
    assert float(slopes.min()) >= 0.1 and float(slopes.max()) < 0.3
    assert abs(float(slopes.mean()) - 0.2) < 5e-3
    # drawn from a generator seeded from the port's RandomGenerator, so its
    # seed reproduces them
    trng.manual_seed(11)
    a = nn.RReLU()(x)
    trng.manual_seed(11)
    b = nn.RReLU()(x)
    assert torch.equal(a, b)
    pos = torch.ones(10)
    assert torch.equal(nn.RReLU()(pos), pos)


def test_gradient_reversal_is_an_autograd_function():
    m = nn.GradientReversal(2.0)
    x = torch.ones(3, requires_grad=True)
    y = m(x)
    assert type(y.grad_fn).__name__.startswith("_Reverse")
    y.sum().backward()
    assert x.grad.tolist() == [-2.0, -2.0, -2.0]
    assert m.set_lambda(0.5) is m and m.the_lambda == 0.5


# ----------------------------------------------------------- module surface
def _mlp(pkg, reg=None):
    return (pkg.Sequential().add(pkg.Linear(6, 5, True, reg))
            .add(pkg.Tanh()).add(pkg.Linear(5, 3)).add(pkg.Sigmoid()))


def test_tensor_module_marks_the_tensor_layers():
    assert issubclass(nn.TensorModule, nn.Module)
    for cls in (nn.Linear, nn.ReLU, nn.Reshape, nn.SpatialConvolution,
                nn.BatchNormalization, nn.SpatialMaxPooling):
        assert issubclass(cls, nn.TensorModule), cls


def test_regularizer_tree_matches_reference():
    jm, tm = _mlp(jnn, jnn.L2Regularizer(0.1)), _mlp(nn, nn.L2Regularizer(0.1))

    def shape(tree):
        return {k: (shape(v) if isinstance(v, dict)
                    else None if v is None else (type(v).__name__, v.l1, v.l2))
                for k, v in tree.items()}

    assert shape(tm.regularizer_tree()) == shape(jm.regularizer_tree())
    assert [n for n, _ in nn.named_regularizers(tm)] == ["0.weight"]


def test_register_parameter_keeps_torch_behaviour():
    m = nn.Module()
    m.register_parameter("w", torch.nn.Parameter(torch.ones(2)))
    m.register_parameter("b", None)
    m.register_parameter("v", torch.zeros(3), nn.L1Regularizer(0.5))
    assert [n for n, _ in m.named_parameters()] == ["w", "v"]
    assert isinstance(m.v, torch.nn.Parameter)
    assert m.regularizer_tree()["v"].l1 == 0.5
    assert m.regularizer_tree()["w"] is None
    m.w = torch.nn.Parameter(torch.ones(4))   # attribute assignment
    assert m.w.shape == (4,)


def test_timing_lists_every_module():
    tm = _mlp(nn)
    x = torch.from_numpy(_x((4, 6), 5)).requires_grad_()
    tm(x).sum().backward()
    assert all(f == 0.0 and b == 0.0 for _, f, b in tm.get_times())
    nn.enable_timing()
    try:
        assert module_mod._TIMING_HANDLES
        for _ in range(2):
            tm(torch.from_numpy(_x((4, 6), 5))).sum().backward()
    finally:
        nn.enable_timing(False)
    times = tm.get_times()
    assert [m for m, _, _ in times] == list(tm.modules())
    assert all(f > 0 and b > 0 for _, f, b in times), times
    seq = times[0]
    assert seq[1] >= max(f for _, f, _ in times[1:])
    assert "Linear" in tm.time_report()
    tm.reset_times()
    assert all(f == 0.0 and b == 0.0 for _, f, b in tm.get_times())
    tm(torch.from_numpy(_x((4, 6), 5))).sum().backward()
    assert all(f == 0.0 and b == 0.0 for _, f, b in tm.get_times())


def test_timing_leaves_the_values_unchanged():
    tm = _mlp(nn)
    x = torch.from_numpy(_x((4, 6), 5))
    plain = tm(x)
    nn.enable_timing()
    try:
        timed = tm(x)
        with torch.no_grad():
            nograd = tm(x)
    finally:
        nn.enable_timing(False)
    assert torch.equal(plain, timed) and torch.equal(plain, nograd)


def test_timing_names_match_reference_order():
    jm, tm = _mlp(jnn), _mlp(nn)
    assert ([type(m).__name__ for m, _, _ in jm.get_times()]
            == [type(m).__name__ for m, _, _ in tm.get_times()])
