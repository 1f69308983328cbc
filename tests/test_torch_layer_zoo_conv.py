"""The layer zoo's convolutions in the port against the JAX package's, on
the CPU: ``SpatialShareConvolution``, ``SpatialDilatedConvolution``,
``SpatialFullConvolution`` (stride, padding, ``adj``, groups, no bias),
``VolumetricConvolution`` (NDHWC) and ``SpatialConvolutionMap`` (full,
one-to-one and random connection tables). The reference's weights are
carried into the port (``import_tree_state``, names and HWIO layouts
unchanged); the same numpy inputs go through both. Forward, input and
parameter gradients (one random cotangent) agree within 1e-5 of max|ref|.
The normalizations: ``test_torch_layer_zoo_normalization.py``.
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


# ----------------------------------------------------------------- convs
CONVS = [
    ("SpatialShareConvolution", (3, 4, 3, 3, 1, 1, 1, 1), (2, 6, 5, 3)),
    ("SpatialDilatedConvolution", (3, 4, 3, 3, 1, 1, 2, 2, 2, 2),
     (2, 7, 8, 3)),
    ("SpatialDilatedConvolution", (2, 3, 3, 2, 2, 1, 0, 1, 1, 3),
     (9, 8, 2)),
    ("SpatialFullConvolution", (3, 4, 3, 3, 2, 2, 1, 1, 1, 1),
     (2, 4, 5, 3)),
    ("SpatialFullConvolution", (4, 6, 3, 2, 2, 3, 1, 0, 0, 2, 2),
     (1, 3, 4, 4)),
    ("SpatialFullConvolution", (3, 2, 4, 4, 2, 2, 1, 1, 0, 0, 1, True),
     (4, 4, 3)),
    ("VolumetricConvolution", (3, 4, 2, 3, 3, 1, 1, 1, 1, 1, 1),
     (2, 4, 5, 5, 3)),
    ("VolumetricConvolution", (2, 3, 3, 2, 2, 2, 1, 2, 0, 1, 0, False),
     (5, 4, 6, 2)),
]


@pytest.mark.parametrize("name,args,shape", CONVS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CONVS)])
def test_conv_matches_reference(name, args, shape):
    jm, tm = getattr(jnn, name)(*args), getattr(nn, name)(*args)
    assert sorted(export_tree_state(tm)[0]) == sorted(
        flatten_tree(jm.parameter_tree()))
    _parity(jm, tm, [_x(shape)], RTOL)


@pytest.mark.parametrize("table", ["full", "one_to_one", "random"])
def test_spatial_convolution_map(table):
    conn = {"full": lambda m: m.full(3, 4),
            "one_to_one": lambda m: m.one_to_one(3),
            "random": lambda m: m.random(4, 3, 2)}[table]
    jconn = conn(jnn.SpatialConvolutionMap)
    tconn = conn(nn.SpatialConvolutionMap)
    if table != "random":
        assert np.array_equal(jconn, tconn)
    assert tconn.shape[1] == 2 and tconn.min() >= 1
    jm = jnn.SpatialConvolutionMap(jconn, 3, 3, 1, 1, 1, 1)
    tm = nn.SpatialConvolutionMap(jconn, 3, 3, 1, 1, 1, 1)
    _parity(jm, tm, [_x((2, 5, 6, jm.n_input_plane))], RTOL)
