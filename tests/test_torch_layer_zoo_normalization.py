"""The layer zoo's normalizations in the port against the JAX package's, on
the CPU: ``InputNormalize``, ``Normalize`` (p = 1, 2, 3, inf), the
subtractive / divisive / contrastive local normalizations (the default
gaussian, and given 1-D and non-square 2-D kernels, whose windows reach
past the borders: the edge correction) and ``VolumetricBatchNormalization``
(train and eval). The reference's buffers are carried in; forward and
gradients agree within 1e-5 of max|ref|.
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


# -------------------------------------------------------- normalizations
def test_input_normalize():
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.3, 0.25]
    x = np.random.default_rng(0).integers(0, 256, (2, 3, 4, 3)).astype(
        np.uint8)
    ref = jnn.InputNormalize(mean, std).forward(jnp.asarray(x))
    got = nn.InputNormalize(mean, std)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, RTOL)
    _parity(jnn.InputNormalize(mean, std), nn.InputNormalize(mean, std),
            [_x((2, 3, 4, 3))], RTOL)


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0, float("inf")])
def test_normalize(p):
    _parity(jnn.Normalize(p), nn.Normalize(p), [_x((3, 7))], RTOL)


_KERNELS = {"default": None, "1d": np.array([1.0, 2.0, 1.0], np.float32),
            "2d": np.arange(1.0, 16.0, dtype=np.float32).reshape(5, 3)}


@pytest.mark.parametrize("kernel", list(_KERNELS))
@pytest.mark.parametrize("name", ["SpatialSubtractiveNormalization",
                                  "SpatialDivisiveNormalization",
                                  "SpatialContrastiveNormalization"])
def test_local_normalizations(name, kernel):
    k = _KERNELS[kernel]
    jm, tm = getattr(jnn, name)(3, k), getattr(nn, name)(3, k)
    assert sorted(export_tree_state(tm)[1]) == sorted(
        flatten_tree(jm.buffer_tree()))
    _parity(jm, tm, [_x((2, 11, 10, 3), 1, 1.0, 0.5)], RTOL)


def test_local_normalization_unbatched():
    _parity(jnn.SpatialContrastiveNormalization(2),
            nn.SpatialContrastiveNormalization(2), [_x((9, 9, 2))], RTOL)


@pytest.mark.parametrize("train", [True, False])
def test_volumetric_batch_normalization(train):
    jm, tm = jnn.VolumetricBatchNormalization(3), \
        nn.VolumetricBatchNormalization(3)
    jm.running_var = jnp.asarray(_x((3,), 4) ** 2 + 0.5)
    _parity(jm, tm, [_x((2, 3, 4, 5, 3), 2, 2.0, 1.0)], RTOL, train=train)


@pytest.mark.parametrize("shape", [(2, 512), (8, 4, 4, 64)])
def test_batch_norm_variance_of_close_values(shape):
    """Train-mode batch norm keeps the variance of a channel whose values
    lie close together (ROADMAP C.6): values 1000 + N(0, 0.1) in f32, the
    batch variance within 1e-2 of the values' variance (0.01) of its f64
    value in every channel. The one-pass ``E[x^2] - E[x]^2`` that the
    reference takes misses by up to 0.24 here in f32 (its rounding step
    at 1e6 is 0.0625)."""
    from bigdl_tpu_torch.ops.batch_norm import batch_norm_train
    x = (1000 + np.random.default_rng(0).normal(0, 0.1, shape)
         ).astype(np.float32)
    c = shape[-1]
    _, _, var = batch_norm_train(torch.from_numpy(x), torch.ones(c),
                                 torch.zeros(c), 1e-5)
    want = x.astype(np.float64).reshape(-1, c).var(0)
    assert np.abs(var.numpy() - want).max() <= 1e-2 * 0.1 ** 2
