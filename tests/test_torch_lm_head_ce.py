"""The port's fused LM-head cross-entropy against the JAX package's.

``bigdl_tpu_torch.ops.lm_head_ce.fused_lm_head_ce`` (a
``torch.autograd.Function`` looping over vocabulary chunks) against
``jax.grad`` of ``bigdl_tpu.ops.lm_head_ce.fused_lm_head_ce`` on the same
numpy inputs: the loss and the gradients of hidden, weight and bias, in f32
within 1e-5 (absolute and relative; both sum the same f32 products in
different orders). Chunk sizes V, 7 (a ragged last chunk, whose padded rows
carry the -1e30 bias) and 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.criterion import FusedLMHeadCriterion as JaxFusedCriterion
from bigdl_tpu.ops import lm_head_ce as jax_ce
from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
from bigdl_tpu_torch.ops import lm_head_ce as ce

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
V, E = 30, 12


def _inputs(lead, seed, bias=True, ignore=None):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(lead + (E,)).astype(np.float32)
    w = (rng.standard_normal((V, E)) * 0.5).astype(np.float32)
    b = rng.standard_normal(V).astype(np.float32) if bias else None
    t = rng.integers(1, V + 1, lead).astype(np.float32)
    if ignore is not None:
        t.reshape(-1)[::3] = ignore
    return h, w, b, t


def _jax(h, w, b, t, **kw):
    def loss(h_, w_, b_):
        return jax_ce.fused_lm_head_ce(h_, w_, b_, jnp.asarray(t), **kw)
    args = [jnp.asarray(h), jnp.asarray(w),
            None if b is None else jnp.asarray(b)]
    argnums = (0, 1) if b is None else (0, 1, 2)
    val, grads = jax.value_and_grad(loss, argnums=argnums)(*args)
    return [np.asarray(val)] + [np.asarray(g) for g in grads]


def _port(h, w, b, t, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (h, w)]
    if b is not None:
        ts.append(torch.from_numpy(b).requires_grad_())
    loss = ce.fused_lm_head_ce(ts[0], ts[1], ts[2] if b is not None else None,
                               torch.from_numpy(t), **kw)
    loss.backward()
    return [loss.detach().numpy()] + [x.grad.numpy() for x in ts]


def _check(ref, got):
    assert len(ref) == len(got)
    for r, g, name in zip(ref, got, ("loss", "dh", "dW", "db")):
        np.testing.assert_allclose(g, r, **TOL, err_msg=name)


@pytest.mark.parametrize("chunk", [V, 7, 16])
def test_value_and_grads_match(chunk):
    args = _inputs((10,), seed=chunk)
    _check(_jax(*args, chunk=chunk), _port(*args, chunk=chunk))


@pytest.mark.parametrize("chunk", [V, 7])
def test_ignore_index(chunk):
    args = _inputs((10,), seed=3, ignore=0)
    kw = dict(chunk=chunk, ignore_index=0)
    _check(_jax(*args, **kw), _port(*args, **kw))


def test_sum_reduction():
    args = _inputs((10,), seed=4)
    kw = dict(chunk=7, size_average=False)
    _check(_jax(*args, **kw), _port(*args, **kw))


def test_no_bias():
    args = _inputs((10,), seed=5, bias=False)
    _check(_jax(*args, chunk=16), _port(*args, chunk=16))


def test_3d_hidden():
    args = _inputs((2, 5), seed=6)
    _check(_jax(*args, chunk=7), _port(*args, chunk=7))


def test_lse_cotangent_is_carried():
    # the op's (loss_sum, n_valid, lse) outputs with a cotangent on lse too
    h, w, b, t = _inputs((10,), seed=7)
    valid = np.ones(10, bool)
    valid[2] = False
    tgt0 = t.astype(np.int32) - 1
    g_lse = np.random.default_rng(8).standard_normal(10).astype(np.float32)

    def f(h_, w_, b_):
        return jax_ce._lm_head_ce(h_, w_, b_, jnp.asarray(valid),
                                  jnp.asarray(tgt0), 7)
    out, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    ref = vjp((jnp.float32(0.7), jnp.float32(0.0), jnp.asarray(g_lse)))

    ts = [torch.from_numpy(a).requires_grad_() for a in (h, w, b)]
    loss_sum, _, lse = ce.LMHeadCE.apply(*ts, torch.from_numpy(valid),
                                         torch.from_numpy(tgt0).long(), 7)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(out[2]), **TOL)
    (0.7 * loss_sum + (lse * torch.from_numpy(g_lse)).sum()).backward()
    for r, x in zip(ref, ts):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("ignore", [None, 3])
def test_criterion_eval_path_on_logprobs(ignore):
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 5, V)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    t = rng.integers(1, V + 1, (2, 5)).astype(np.float32)
    t[0, 1] = 3
    ref = JaxFusedCriterion(ignore_index=ignore).forward(jnp.asarray(logp),
                                                         jnp.asarray(t))
    got = FusedLMHeadCriterion(ignore_index=ignore).forward(
        torch.from_numpy(logp), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_criterion_tuple_path_is_the_fused_op():
    h, w, b, t = _inputs((2, 5), seed=10)
    crit = FusedLMHeadCriterion(chunk=7)
    ref = JaxFusedCriterion(chunk=7).forward(
        (jnp.asarray(h), jnp.asarray(w), jnp.asarray(b)), jnp.asarray(t))
    got = crit.forward((torch.from_numpy(h), torch.from_numpy(w),
                        torch.from_numpy(b)), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
