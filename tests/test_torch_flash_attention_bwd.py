"""The port's flash-attention backward against the JAX flash kernels' VJP.

``FlashAttention`` (the port's ``torch.autograd.Function``) runs
``flash_attention_plain`` forward and ``flash_attention_bwd_plain`` backward
on CPU tensors; on the card the same ``Function`` launches kernels K1, K2
and K3. Both are held here against ``jax.vjp`` of the reference's
``flash_attention_with_lse`` with ``block_q = block_k = 8`` in interpret
mode, which runs the Pallas ``_bwd_dq_kernel`` (K2) and ``_bwd_dkv_kernel``
(K3), with cotangents on both the output and the row log-sum-exp.
Tolerance: 2e-4 absolute and relative, the reference's own for its
backward kernels (``tests/test_attention.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash_with_lse
from bigdl_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(b, sq, sk, n, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (f(b, sq, n, d), f(b, sk, n, d), f(b, sk, n, d),
            f(b, sq, n, d), f(b, n, sq))


@functools.partial(jax.jit, static_argnums=5)
def _jax_vjp(q, k, v, g_o, g_lse, causal):
    # jitted: the interpret-mode kernels then compile once instead of
    # dispatching op by op
    f = lambda q_, k_, v_: jax_flash_with_lse(
        q_, k_, v_, causal=causal, block_q=8, block_k=8, interpret=True)
    _, vjp = jax.vjp(f, q, k, v)
    return vjp((g_o, g_lse))


def _jax_grads(q, k, v, g_o, g_lse, causal):
    args = (jnp.asarray(a) for a in (q, k, v, g_o, g_lse))
    return [np.asarray(g) for g in _jax_vjp(*args, causal)]


def _port_grads(q, k, v, g_o, g_lse, causal):
    """Gradients through the autograd Function on CPU tensors."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = fa.flash_attention_with_lse(qt, kt, vt, causal=causal)
    torch.autograd.backward((o, lse), (torch.from_numpy(g_o),
                                       torch.from_numpy(g_lse)))
    return [t.grad.numpy() for t in (qt, kt, vt)]


def _plain_grads(q, k, v, g_o, g_lse, causal):
    """``flash_attention_bwd_plain`` fed the plain forward's o and lse."""
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    o, lse = fa.flash_attention_plain(qt, kt, vt, causal, scale)
    grads = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse,
                                         torch.from_numpy(g_o),
                                         torch.from_numpy(g_lse), causal,
                                         scale)
    return [g.numpy() for g in grads]


def _check(ref, *gots):
    for got in gots:
        for r, g, name in zip(ref, got, "qkv"):
            assert np.isfinite(g).all(), f"d{name} is not finite"
            np.testing.assert_allclose(g, r, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 7, 20, 33])
def test_backward_matches_reference_kernels(causal, s):
    args = _inputs(2, s, s, 2, 16, seed=s)
    ref = _jax_grads(*args, causal)
    _check(ref, _port_grads(*args, causal), _plain_grads(*args, causal))


def test_backward_cross_length_full():
    args = _inputs(1, 5, 19, 3, 16, seed=4)
    ref = _jax_grads(*args, False)
    _check(ref, _port_grads(*args, False), _plain_grads(*args, False))


@pytest.mark.parametrize("causal", [True, False])
def test_backward_dead_row(causal):
    # every logit of (b=0, s=3, h=1) overflows to -inf: the row is dead and
    # carries the float32.min LSE sentinel into the backward
    # (shapes of a case above, so the jitted reference is reused)
    q, k, v, g_o, g_lse = _inputs(2, 7, 7, 2, 16, seed=5)
    q[0, 3, 1] = 0.0
    q[0, 3, 1, 0] = -3e38
    k[:, :, 1, 0] = 100.0
    ref = _jax_grads(q, k, v, g_o, g_lse, causal)
    got = _port_grads(q, k, v, g_o, g_lse, causal)
    _check(ref, got, _plain_grads(q, k, v, g_o, g_lse, causal))
    assert (got[0][0, 3, 1] == 0).all()


def test_lse_cotangent_alone():
    # o unused: the Function gets no output cotangent, only g_lse
    q, k, v, _, g_lse = _inputs(2, 20, 20, 2, 16, seed=6)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    _, lse = fa.flash_attention_with_lse(qt, kt, vt, causal=True)
    (lse * torch.from_numpy(g_lse)).sum().backward()
    ref = _jax_grads(q, k, v, np.zeros_like(q), g_lse, True)
    _check(ref, [t.grad.numpy() for t in (qt, kt, vt)])


def test_cpu_output_goes_through_the_function():
    q, k, v, _, _ = _inputs(1, 6, 6, 2, 64, seed=7)
    qt = torch.from_numpy(q).requires_grad_()
    o, lse = fa.flash_attention_with_lse(qt, torch.from_numpy(k),
                                         torch.from_numpy(v), causal=True)
    assert isinstance(o.grad_fn, fa.FlashAttention._backward_cls)
    assert isinstance(lse.grad_fn, fa.FlashAttention._backward_cls)
    o_only = fa.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v))
    assert isinstance(o_only.grad_fn, fa.FlashAttention._backward_cls)


def test_backward_launches_no_kernel_on_cpu():
    args = _inputs(1, 8, 8, 2, 64, seed=8)
    before = (fa.LAUNCHES.value, fa.LAUNCHES_DQ.value, fa.LAUNCHES_DKV.value)
    _port_grads(*args, True)
    assert (fa.LAUNCHES.value, fa.LAUNCHES_DQ.value,
            fa.LAUNCHES_DKV.value) == before


def test_function_matches_autograd_through_plain_core():
    # the Function's backward against autograd of the plain attention core
    # (what MultiHeadAttention runs on the CPU), as chip_smoke.py does on
    # the card at the training shape
    from bigdl_tpu_torch.ops.attention_core import dot_product_attention
    q, k, v, g_o, _ = _inputs(2, 17, 17, 3, 64, seed=9)
    got = []
    for core in (lambda a, b, c: fa.flash_attention(a, b, c, causal=True),
                 lambda a, b, c: dot_product_attention(a, b, c, causal=True)):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        core(*ts).backward(torch.from_numpy(g_o))
        got.append([t.grad.numpy() for t in ts])
    _check(got[1], got[0])


def test_kernel_wrappers_run_plain_versions_on_cpu_tensors():
    q, k, v, g_o, g_lse = (torch.from_numpy(a)
                           for a in _inputs(1, 9, 9, 2, 64, seed=10))
    o, lse = fa.flash_attention_plain(q, k, v, True, 0.125)
    delta = fa.bwd_delta(o, g_o, g_lse)
    args = (q, k, v, g_o, lse, delta, True, 0.125)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    for got, want in zip((dq, dk, dv), fa.flash_attention_bwd_plain(
            q, k, v, o, lse, g_o, g_lse, True, 0.125)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["g_o_dtype", "g_o_layout", "lse_shape",
                                 "delta_dtype"])
def test_backward_kernel_argument_checks(bad):
    q = k = v = g_o = torch.zeros(2, 8, 4, 64)
    lse = delta = torch.zeros(2, 4, 8)
    fa._check_bwd_args(q, k, v, g_o, lse, delta)  # what the kernels take
    if bad == "g_o_dtype":
        g_o = g_o.to(torch.bfloat16)
    elif bad == "g_o_layout":
        g_o = torch.zeros(2, 4, 8, 64).transpose(1, 2)
    elif bad == "lse_shape":
        lse = torch.zeros(2, 8, 4)
    else:
        delta = delta.double()
    with pytest.raises(ValueError):
        fa._check_bwd_args(q, k, v, g_o, lse, delta)
