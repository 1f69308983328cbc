"""``SoftmaxWithCriterion`` (Caffe's softmax loss, classes on axis 1) in
the port against the JAX package's, on the CPU: no, an in-range and an
out-of-range ignore label in each normalize mode (``VALID``, ``FULL``,
``BATCH_SIZE``, ``NONE``); the loss and its input gradient (``jax.grad``
against autograd) within 1e-6 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.utils.rng import RandomGenerator as PortRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.table import T

TOL = 1e-6
R = np.random.RandomState(1)
N, C = 4, 5


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


def _close(got, ref, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, (what, err)


def _jt(v):
    if isinstance(v, list):
        return JT(*[_jt(a) for a in v])
    return None if v is None else jnp.asarray(v)


def _tt(v):
    if isinstance(v, list):
        return [_tt(a) for a in v]
    return None if v is None else torch.from_numpy(np.array(v))


def _crit(jc, tc, x, t, tol=TOL):
    """Loss and input gradients of the two criteria on input ``x`` (an
    array, or a list of arrays: a table) and target ``t``."""
    xs = x if isinstance(x, list) else [x]

    def f(*a):
        return jc.apply(JT(*a) if isinstance(x, list) else a[0], _jt(t))

    ref = f(*map(jnp.asarray, xs))
    ref_g = jax.grad(f, argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))
    txs = [torch.from_numpy(np.array(a)).requires_grad_() for a in xs]
    got = tc(txs if isinstance(x, list) else txs[0], _tt(t))
    _close(got.detach().numpy(), ref, tol, "loss")
    got.backward()
    for a, g in zip(txs, ref_g):
        _close(a.grad.numpy(), g, tol, "grad")


def _logp():
    return np.log(R.dirichlet(np.ones(C), N)).astype(np.float32)


def _labels():
    return (R.randint(0, C, N) + 1).astype(np.float32)


def _scores():
    return R.randn(N, C).astype(np.float32)


def _probs():
    return R.uniform(0.05, 0.95, (N, C)).astype(np.float32)


def _pm_ones(shape=(N, C)):
    return (R.randint(0, 2, shape) * 2 - 1).astype(np.float32)


def _bits():
    return R.randint(0, 2, (N, C)).astype(np.float32)


@pytest.mark.parametrize("mode", ["VALID", "FULL", "BATCH_SIZE", "NONE"])
@pytest.mark.parametrize("ignore", [None, 2, 255])
def test_softmax_with_criterion_modes(mode, ignore):
    x = R.randn(3, C, 2, 4).astype(np.float32)      # (N, C, H, W)
    t = (R.randint(0, C, (3, 2, 4)) + 1).astype(np.float32)
    if ignore is not None:
        t[0, 0, :2] = ignore
    _crit(jnn.SoftmaxWithCriterion(ignore, mode),
          nn.SoftmaxWithCriterion(ignore, mode), x, t)
