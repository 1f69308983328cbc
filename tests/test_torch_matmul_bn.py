"""The port's 1x1 conv + BN path against the JAX package's, on the CPU.

Kernel K5's plain version (``matmul_with_stats_plain``, what the CPU runs)
against the reference's ``matmul_with_stats`` (the Pallas kernel in
interpret mode, its default off TPU); ``conv1x1_bn_train``'s forward and
gradients against the reference's ``custom_vjp``; ``FusedConv1x1BN`` in
train and eval modes, with its running statistics. Inputs are made with
numpy from seeds and weights are carried across through
``interop.state_dict``.

Tolerances. f32: y within 1e-5 of max|y| (f32 sums in another order); the
column sums within 1e-5 of sum|y| and sum y^2. bf16: y within one bf16
step of the element (2^-7 |ref|): both round the same f32 product, which
may sit on a rounding boundary; the sums are f32 of the same products,
1e-5 as in f32. The training op and the module: 1e-5 of max|ref| for
outputs and statistics, 1e-4 for gradients (the closed-form BN backward
subtracts sums of order M).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.fused import FusedConv1x1BN as JaxFusedConv1x1BN
from bigdl_tpu.ops.conv_bn import conv1x1_bn_train as jax_conv1x1_bn_train
from bigdl_tpu.ops.matmul_bn import matmul_with_stats as jax_matmul_with_stats
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state
from bigdl_tpu_torch.nn.fused import FusedConv1x1BN
from bigdl_tpu_torch.ops import matmul_bn
from bigdl_tpu_torch.ops.conv_bn import conv1x1_bn_train
from bigdl_tpu_torch.ops.matmul_bn import (matmul_with_stats,
                                           matmul_with_stats_kernel,
                                           matmul_with_stats_plain)

torch.set_num_threads(1)

EPS = 1e-5
F32_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_STEP = 2.0 ** -7


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, ref, rtol, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), (what, err)


def _stats_close(s, sq, ref_y):
    ref = np.asarray(ref_y, np.float32).reshape(-1, ref_y.shape[-1])
    _close_to(s, ref.sum(0), F32_RTOL * np.abs(ref).sum(0).max())
    _close_to(sq, (ref * ref).sum(0), F32_RTOL * (ref * ref).sum(0).max())


def _close_to(got, ref, atol):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32))
    assert err.max() <= atol, (err.max(), atol)


SHAPES = [(512, 64, 256), (300, 48, 100), (64, 16, 128), (257, 3, 5),
          (1000, 12, 70)]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(m, k, n, dtype):
    x, w = _rand(m, k), _rand(k, n, seed=1) / np.sqrt(k)
    jdt = jnp.dtype(dtype)
    jy, js, jsq = jax_matmul_with_stats(jnp.asarray(x, jdt),
                                        jnp.asarray(w, jdt), interpret=True)
    tdt = getattr(torch, dtype)
    y, s, sq = matmul_with_stats(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(w).to(tdt))
    assert y.dtype == tdt and s.dtype == sq.dtype == torch.float32
    assert s.shape == sq.shape == (n,)
    ref_y = np.asarray(jy.astype(jnp.float32))
    got_y = y.float().numpy()
    if dtype == "float32":
        _close(got_y, ref_y, F32_RTOL)
    else:
        assert (np.abs(got_y - ref_y) <= BF16_STEP * np.abs(ref_y)).all()
    # the sums come from the f32 product, before y is rounded
    y32 = (torch.from_numpy(x).to(tdt).float()
           @ torch.from_numpy(w).to(tdt).float()).numpy()
    _stats_close(s.numpy(), sq.numpy(), y32)
    _stats_close(np.asarray(js), np.asarray(jsq), y32)


def test_mixed_dtypes_promote_and_keep_x_dtype():
    x = torch.from_numpy(_rand(40, 8)).to(torch.bfloat16)
    w = torch.from_numpy(_rand(8, 6, seed=1))
    y, s, _ = matmul_with_stats(x, w)
    assert y.dtype == torch.bfloat16
    ref = x.float() @ w
    torch.testing.assert_close(s, ref.sum(0), rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    before = matmul_bn.LAUNCHES.value
    x, w = torch.zeros(4, 4), torch.zeros(4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        matmul_with_stats_kernel(x, w)
    matmul_with_stats(x, w)   # the CPU takes the plain version
    assert matmul_bn.LAUNCHES.value == before
    y, s, sq = matmul_with_stats_plain(x, w)
    assert y.shape == (4, 4) and s.shape == sq.shape == (4,)


def _jax_train(x, w, g, b, cot):
    def f(x_, w_, g_, b_):
        return jax_conv1x1_bn_train(x_, w_, g_, b_, EPS, True)
    (out, mean, var), vjp = jax.vjp(f, *map(jnp.asarray, (x, w, g, b)))
    grads = vjp((jnp.asarray(cot), jnp.zeros_like(mean), jnp.zeros_like(var)))
    return [np.asarray(t) for t in (out, mean, var, *grads)]


@pytest.mark.parametrize("m,k,n", [(96, 24, 40), (300, 48, 100)])
def test_training_op_matches_reference_vjp(m, k, n):
    x, w = _rand(m, k), _rand(k, n, seed=1) * 0.3
    g, b = _rand(n, seed=2) * 0.1 + 1.0, _rand(n, seed=3) * 0.1
    cot = _rand(m, n, seed=7)   # random: a sum(out^2) loss is nearly flat
    ref = _jax_train(x, w, g, b, cot)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, g, b)]
    out, mean, var = conv1x1_bn_train(*ts, EPS)
    assert not mean.requires_grad and not var.requires_grad
    out.backward(torch.from_numpy(cot))
    got = [out.detach(), mean, var] + [t.grad for t in ts]
    names = ["out", "mean", "var", "dx", "dw", "dgamma", "dbeta"]
    for name, r, o in zip(names, ref, got):
        _close(o.numpy(), r, F32_RTOL if name in ("out", "mean", "var")
               else GRAD_RTOL, name)


def _module_pair(cin, cout, stride, with_bias):
    jmod = JaxFusedConv1x1BN(cin, cout, stride, with_bias=with_bias)
    tmod = FusedConv1x1BN(cin, cout, stride, with_bias=with_bias)
    # non-trivial gamma, beta and running statistics
    p = flatten_tree(jmod.parameter_tree())
    p["gamma"] = _rand(cout, seed=4) * 0.1 + 1.0
    p["beta"] = _rand(cout, seed=5) * 0.1
    bufs = {"running_mean": _rand(cout, seed=6) * 0.1,
            "running_var": np.abs(_rand(cout, seed=8)) + 0.5}
    jmod.load_parameter_tree({k: jnp.asarray(v) for k, v in p.items()})
    jmod.load_buffer_tree({k: jnp.asarray(v) for k, v in bufs.items()})
    import_tree_state(tmod, p, bufs)
    return jmod, tmod


@pytest.mark.parametrize("stride,with_bias", [(1, False), (2, False),
                                              (1, True), (2, True)])
def test_fused_module_train_and_eval_match_reference(stride, with_bias):
    jmod, tmod = _module_pair(8, 12, stride, with_bias)
    x = _rand(3, 6, 5, 8, seed=9)
    ref = np.asarray(jmod.forward(jnp.asarray(x)))
    got = tmod(torch.from_numpy(x))
    assert got.shape == ref.shape
    _close(got.detach().numpy(), ref, F32_RTOL, "train out")
    ref_bufs = flatten_tree(jmod.buffer_tree())
    for name, buf in tmod.named_buffers():
        _close(buf.numpy(), ref_bufs[name], F32_RTOL, name)
    jmod.evaluate_mode()
    tmod.evaluate_mode()
    ref = np.asarray(jmod.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    _close(got.numpy(), ref, F32_RTOL, "eval out")
