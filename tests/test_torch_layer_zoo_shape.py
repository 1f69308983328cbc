"""The layer zoo's shape layers in the port against the JAX package's, on
the CPU: every class of ``bigdl_tpu/nn/shape.py`` with the reference's
1-based dimensions, negative indices and batch modes, built in both
packages with the same arguments; the forward and the input gradient (one
random cotangent, ``jax.vjp`` against autograd) agree within 1e-6 of
max|ref| in f32.
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


# ------------------------------------------------------------------- shapes
SHAPES = [
    ("View", ((4, 5),), (3, 20)), ("View", (60,), (3, 4, 5)),
    ("InferReshape", ((-1, 10),), (3, 4, 5)),
    ("InferReshape", ((0, -1), True), (2, 3, 4, 5)),
    ("Squeeze", (), (3, 1, 4, 1)), ("Squeeze", (2,), (3, 1, 4)),
    ("Squeeze", (1, 2), (3, 1, 4)), ("Unsqueeze", (2,), (3, 4)),
    ("Unsqueeze", (1, 2), (3, 4, 5)), ("Replicate", (3,), (4, 5)),
    ("Replicate", (2, 2, 2), (3, 4, 5)),
    ("SpatialZeroPadding", (1, 2, 0, 3), (2, 4, 5, 3)),
    ("SpatialZeroPadding", (-1, 1, 2, -1), (4, 5, 3)),
    ("Narrow", (2, 2, 3), (3, 6, 2)), ("Narrow", (1, 2, -2), (6, 4)),
    ("Narrow", (-1, 2, 2), (3, 5, 4)),
    ("Select", (2, 3), (3, 5, 4)), ("Select", (-1, -2), (3, 5, 4)),
    ("Reverse", (2,), (3, 4, 5)), ("Reverse", (), (3, 4)),
    ("Contiguous", (), (3, 4)), ("Reshape", ((2, 10),), (3, 4, 5)),
    ("Transpose", ([(1, 3)],), (2, 3, 4)),
    ("Padding", (1, -2, 2, 0.5), (3, 4, 5)),
]


@pytest.mark.parametrize("name,args,shape", SHAPES,
                         ids=[f"{a[0]}{i}" for i, a in enumerate(SHAPES)])
def test_shape_layer_matches_reference(name, args, shape):
    _parity(getattr(jnn, name)(*args), getattr(nn, name)(*args),
            [_x(shape, 3)], TOL)


def test_every_reference_shape_layer_is_covered():
    import bigdl_tpu.nn.shape as ref
    names = {n for n, v in vars(ref).items()
             if isinstance(v, type) and v.__module__ == ref.__name__}
    assert names <= {a[0] for a in SHAPES}
