"""The layer zoo's table modules in the port against the JAX package's, on
the CPU.

Every container of ``bigdl_tpu/nn/containers.py`` (1-based table keys and
dimensions; a reference ``Table`` is a list in the port, and either goes
in). The same numpy inputs (from a seed) go through both packages with
the reference's weights carried in; the forward, input and parameter
gradients (one random cotangent, ``jax.vjp`` against autograd) agree
within 1e-6 of max|ref| for the elementwise table ops and within 1e-5 for
the ones with products and reductions. The linear layers:
``test_torch_layer_zoo_linear.py``.
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
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.utils.table import T

TOL = 1e-6
RTOL = 1e-5

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


# ------------------------------------------------------------- table ops
def _three(shape=(3, 4), seed=0):
    return [_x(shape, seed + i) for i in range(3)]


ELEMENTWISE = [("CAddTable", ()), ("CSubTable", ()), ("CMulTable", ()),
               ("CDivTable", ()), ("CMaxTable", ()), ("CMinTable", ())]


@pytest.mark.parametrize("name,args", ELEMENTWISE)
def test_elementwise_table_ops(name, args):
    xs = _three()
    if name == "CDivTable":
        xs[1] = xs[1] + np.sign(xs[1]) * 2.0   # away from 0
    _parity(getattr(jnn, name)(*args), getattr(nn, name)(*args), xs, TOL,
            table=True)


@pytest.mark.parametrize("name,args,shape", [
    ("JoinTable", (1,), (3, 4)), ("JoinTable", (2,), (3, 4)),
    ("JoinTable", (1, 1), (3, 4)), ("JoinTable", (2, 2), (2, 3, 4)),
    ("SelectTable", (2,), (3, 4)), ("NarrowTable", (2, 2), (3, 4)),
    ("NarrowTable", (1, -1), (3, 4)), ("FlattenTable", (), (3, 4))])
def test_table_structure_ops(name, args, shape):
    _parity(getattr(jnn, name)(*args), getattr(nn, name)(*args),
            _three(shape), TOL, table=True)


@pytest.mark.parametrize("args,shape", [((1,), (3, 4)), ((2,), (3, 4, 2)),
                                        ((1, 1), (3, 4)), ((-1,), (3, 4))])
def test_split_table(args, shape):
    _parity(jnn.SplitTable(*args), nn.SplitTable(*args), [_x(shape)], TOL)


def test_flatten_table_of_nested_tables():
    a, b, c = (torch.full((2,), float(i)) for i in range(3))
    out = nn.FlattenTable()(T(a, T(b, [c])))
    assert [float(t[0]) for t in out] == [0.0, 1.0, 2.0]


def test_table_inputs_as_table_list_or_tuple():
    xs = [torch.from_numpy(x) for x in _three()]
    m = nn.CSubTable()
    assert torch.equal(m(T(*xs)), m(xs)) and torch.equal(m(tuple(xs)), m(xs))
    assert torch.equal(nn.SelectTable(3)(T(*xs)), xs[2])


@pytest.mark.parametrize("gate_table", [True, False])
def test_mixture_table(gate_table):
    gate = _x((3, 4), 1)
    experts = [_x((3, 5), 2 + i) for i in range(4)]
    jm, tm = jnn.MixtureTable(), nn.MixtureTable()
    if gate_table:
        ref = jm.forward(JT(jnp.asarray(gate), JT(*map(jnp.asarray,
                                                       experts))))
        got = tm([torch.from_numpy(gate), list(map(torch.from_numpy,
                                                   experts))])
        _close(got.numpy(), ref, TOL)
    else:
        _parity(jm, tm, [gate, np.stack(experts, 1)], TOL, table=True)


def test_masked_select_is_the_compact_vector():
    x = _x((4, 5))
    mask = (_x((4, 5), 3) > 0).astype(np.float32)
    ref = jnn.MaskedSelect().forward(JT(jnp.asarray(x), jnp.asarray(mask)))
    got = nn.MaskedSelect()([torch.from_numpy(x), torch.from_numpy(mask)])
    assert got.shape == (int(mask.sum()),)
    _close(got.numpy(), ref, 0.0)


@pytest.mark.parametrize("dim,idx_shape", [(1, (3,)), (2, (5,)), (2, (2, 3))])
def test_index(dim, idx_shape):
    x = _x((4, 6, 3))
    idx = np.random.default_rng(0).integers(1, x.shape[dim - 1] + 1,
                                            idx_shape).astype(np.float32)
    _parity(jnn.Index(dim), nn.Index(dim), [x, idx], TOL, table=True)


@pytest.mark.parametrize("shape,dims", [((2, 3, 6), (2, 2)), ((6,), (2, 2)),
                                        ((2, 3, 4, 6), (2, 2))])
def test_bottle_holds_its_child(shape, dims):
    jm = jnn.Bottle(jnn.Linear(6, 4), *dims)
    tm = nn.Bottle(nn.Linear(6, 4), *dims)
    assert [n for n, _ in tm.named_parameters()] == ["0.weight", "0.bias"]
    _parity(jm, tm, [_x(shape)], RTOL)


def test_map_and_parallel_tables_register_their_children():
    jm = jnn.MapTable(jnn.Linear(4, 3))
    tm = nn.MapTable(nn.Linear(4, 3))
    assert sorted(export_tree_state(tm)[0]) == sorted(
        flatten_tree(jm.parameter_tree()))
    _parity(jm, tm, _three((2, 4)), RTOL, table=True)
    jp = jnn.ParallelTable().add(jnn.Linear(4, 3)).add(jnn.Tanh()) \
        .add(jnn.Linear(4, 2))
    tp = nn.ParallelTable().add(nn.Linear(4, 3)).add(nn.Tanh()) \
        .add(nn.Linear(4, 2))
    assert len(list(tp.parameters())) == 4
    _parity(jp, tp, _three((2, 4)), RTOL, table=True)
    g_in = nn.Input().inputs()
    out = nn.ParallelTable().add(nn.Linear(4, 3)).inputs(g_in)
    assert len(list(nn.Graph(g_in, out).parameters())) == 2


def test_echo_prints_and_passes(capsys):
    x = torch.ones(2, 3)
    assert nn.Echo()(x) is x
    assert "Echo: torch.Size([2, 3])" in capsys.readouterr().out


def test_every_reference_container_is_covered():
    import bigdl_tpu.nn.containers as ref
    names = {n for n, v in vars(ref).items()
             if isinstance(v, type) and v.__module__ == ref.__name__}
    import bigdl_tpu_torch.nn.containers as port
    assert names <= set(vars(port)), names - set(vars(port))
