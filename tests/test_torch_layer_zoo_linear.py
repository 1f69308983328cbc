"""The layer zoo's linear layers in the port against the JAX package's, on
the CPU: every class of ``bigdl_tpu/nn/linear.py`` (``Add``, ``Scale``,
``Bilinear``, ``Cosine``, ``Euclidean``, ``MM``, ``MV``, ``DotProduct``),
``LookupTable``'s padding and max-norm options (and their quantized twin),
and the ``w_regularizer`` / ``b_regularizer`` positions of ``Linear``,
``LMHead``, ``SpatialConvolution`` and ``SpaceToDepthConv7``. The same
numpy inputs go through both packages with the reference's weights
carried in; forward, input and parameter gradients agree within 1e-5 of
max|ref|.
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


# -------------------------------------------------------------- linear
@pytest.mark.parametrize("name,args,inputs", [
    ("Add", (5,), [(3, 5)]), ("Scale", ((4, 5),), [(3, 4, 5)]),
    ("Cosine", (5, 4), [(3, 5)]), ("Euclidean", (5, 4), [(3, 5)]),
    ("Linear", (5, 4, False), [(3, 5)]),
    ("Bilinear", (3, 4, 5), [(6, 3), (6, 4)]),
    ("Bilinear", (3, 4, 2, False), [(6, 3), (6, 4)]),
    ("MM", (), [(2, 3, 4), (2, 4, 5)]), ("MM", (True, True),
                                         [(2, 4, 3), (2, 5, 4)]),
    ("MV", (), [(2, 3, 4), (2, 4)]), ("MV", (True,), [(2, 4, 3), (2, 4)]),
    ("DotProduct", (), [(3, 6), (3, 6)])])
def test_linear_layer_matches_reference(name, args, inputs):
    table = len(inputs) > 1
    _parity(getattr(jnn, name)(*args), getattr(nn, name)(*args),
            [_x(s, 4 + i) for i, s in enumerate(inputs)], RTOL, table=table)


def _ids(shape, n, seed=0):
    return np.random.default_rng(seed).integers(1, n + 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("kw", [{}, {"padding_value": 3.0},
                                {"max_norm": 1.5},
                                {"max_norm": 2.0, "norm_type": 1.0},
                                {"padding_value": 2.0, "max_norm": 1.0,
                                 "should_scale_grad_by_freq": True}])
def test_lookup_table_options(kw):
    jm = jnn.LookupTable(7, 4, **kw)
    tm = nn.LookupTable(7, 4, **kw)
    ids = _ids((3, 5), 7)
    ids[0, :3] = [3.0, 2.0, 3.0]
    _parity(jm, tm, [ids], RTOL)
    # the stored table is not renormalised, as in the reference
    w = tm.weight.detach().clone()
    tm(torch.from_numpy(ids))
    assert torch.equal(tm.weight.detach(), w)


def test_max_norm_lookup_table_cannot_be_tied_or_quantized():
    embed = nn.LookupTable(7, 4, max_norm=1.0)
    with pytest.raises(ValueError, match="max-norm"):
        nn.TiedLMHead(embed)
    from bigdl_tpu_torch.nn.quantized import quantize_model
    with pytest.raises(ValueError, match="max-norm"):
        quantize_model(nn.Sequential().add(embed), device="cpu")


def test_quantized_lookup_table_pads_like_the_reference():
    from bigdl_tpu.nn.quantized import quantize_model as jq
    from bigdl_tpu_torch.nn.quantized import quantize_model as tq
    jm = jnn.Sequential().add(jnn.LookupTable(7, 4, padding_value=2.0))
    tm = nn.Sequential().add(nn.LookupTable(7, 4, padding_value=2.0))
    import_tree_state(tm, flatten_tree(jm.parameter_tree()), {})
    ids = _ids((3, 5), 7)
    ref = np.asarray(jq(jm, jnp.float32).forward(jnp.asarray(ids)))
    got = tq(tm, torch.float32, device="cpu")(torch.from_numpy(ids))
    _close(got.numpy(), ref, RTOL)
    assert np.all(ref[ids == 2.0] == 0)


@pytest.mark.parametrize("cls,args", [
    ("Linear", (5, 4, True)), ("LMHead", (5, 4, True)),
    ("SpatialConvolution", (3, 4, 3, 3, 1, 1, 1, 1, 1, True, True)),
    ("SpaceToDepthConv7", (3, 4, True, "default"))])
def test_regularizers_in_the_reference_positions(cls, args):
    wr, br = nn.L1Regularizer(0.5), nn.L2Regularizer(0.25)
    jwr, jbr = jnn.L1Regularizer(0.5), jnn.L2Regularizer(0.25)
    tm = getattr(nn, cls)(*args, wr, br)
    jm = getattr(jnn, cls)(*args, jwr, jbr)
    tree, jtree = tm.regularizer_tree(), jm.regularizer_tree()
    assert tree["weight"] is wr and tree["bias"] is br
    assert type(jtree["weight"]) is jnn.L1Regularizer
    assert type(jtree["bias"]) is jnn.L2Regularizer


def test_every_reference_linear_layer_is_covered():
    import bigdl_tpu.nn.linear as ref
    import bigdl_tpu_torch.nn.linear as port
    names = {n for n, v in vars(ref).items()
             if isinstance(v, type) and v.__module__ == ref.__name__}
    assert names <= set(vars(port))
