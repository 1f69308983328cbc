"""The port's 3x3 conv + BN path against the JAX package's, on the CPU.

Kernel K6's plain version (``conv3x3_with_stats_plain``, what the CPU runs)
against the reference's ``conv3x3_with_stats`` (the Pallas kernel in
interpret mode) at the reference tests' shapes (odd 5x7, Cin=3, Cout not a
multiple of a tile); ``conv3x3_bn_train``'s forward and gradients against
the reference's ``custom_vjp``; ``FusedConv3x3BN`` in train and eval modes,
with its running statistics. Inputs are made with numpy from seeds.

Tolerances as in ``test_torch_matmul_bn.py``: f32 outputs and statistics
within 1e-5 of max|ref| (sums within 1e-5 of sum|y| and sum y^2); bf16 y
within one bf16 step of the element; gradients within 1e-4 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.fused import FusedConv3x3BN as JaxFusedConv3x3BN
from bigdl_tpu.ops.conv3x3_bn import conv3x3_bn_train as jax_conv3x3_bn_train
from bigdl_tpu.ops.conv3x3_bn import conv3x3_with_stats as jax_conv3x3_with_stats
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state
from bigdl_tpu_torch.nn.fused import FusedConv3x3BN
from bigdl_tpu_torch.ops import conv3x3_bn
from bigdl_tpu_torch.ops.conv3x3_bn import (conv3x3_bn_train,
                                            conv3x3_with_stats,
                                            conv3x3_with_stats_kernel)

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


def _sums_close(s, sq, y32):
    y = y32.reshape(-1, y32.shape[-1])
    for got, ref, scale in ((s, y.sum(0), np.abs(y).sum(0).max()),
                            (sq, (y * y).sum(0), (y * y).sum(0).max())):
        assert np.abs(np.asarray(got) - ref).max() <= F32_RTOL * scale


SHAPES = [(2, 8, 8, 4, 8), (1, 5, 7, 3, 2), (3, 4, 4, 8, 16), (2, 6, 9, 16, 70)]


@pytest.mark.parametrize("n,h,w,cin,cout", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(n, h, w, cin, cout, dtype):
    x = _rand(n, h, w, cin)
    wt = _rand(3, 3, cin, cout, seed=1) * 0.3
    jdt = jnp.dtype(dtype)
    jy, js, jsq = jax_conv3x3_with_stats(jnp.asarray(x, jdt),
                                         jnp.asarray(wt, jdt), interpret=True)
    tdt = getattr(torch, dtype)
    xt, wtt = torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt)
    y, s, sq = conv3x3_with_stats(xt, wtt)
    assert y.dtype == tdt and y.shape == (n, h, w, cout)
    assert s.dtype == sq.dtype == torch.float32 and s.shape == (cout,)
    ref_y = np.asarray(jy.astype(jnp.float32))
    got_y = y.float().numpy()
    if dtype == "float32":
        _close(got_y, ref_y, F32_RTOL)
    else:
        assert (np.abs(got_y - ref_y) <= BF16_STEP * np.abs(ref_y)
                + 1e-6).all()
    y32 = torch.nn.functional.conv2d(
        xt.float().permute(0, 3, 1, 2), wtt.float().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1).numpy()
    _sums_close(s.numpy(), sq.numpy(), y32)
    _sums_close(np.asarray(js), np.asarray(jsq), y32)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    before = conv3x3_bn.LAUNCHES.value
    x, w = torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_with_stats_kernel(x, w)
    conv3x3_with_stats(x, w)
    assert conv3x3_bn.LAUNCHES.value == before
    with pytest.raises(ValueError, match="3, 3, Cin"):
        conv3x3_with_stats(x, torch.zeros(3, 3, 4, 3))


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 6, 6, 4, 8), (1, 5, 7, 3, 2)])
def test_training_op_matches_reference_vjp(n, h, w, cin, cout):
    x = _rand(n, h, w, cin)
    wt = _rand(3, 3, cin, cout, seed=1) * 0.3
    g, b = _rand(cout, seed=2) * 0.1 + 1.0, _rand(cout, seed=3) * 0.1
    cot = _rand(n, h, w, cout, seed=7)  # random: sum(out^2) is nearly flat

    def f(x_, w_, g_, b_):
        return jax_conv3x3_bn_train(x_, w_, g_, b_, EPS, True)

    (out, mean, var), vjp = jax.vjp(f, *map(jnp.asarray, (x, wt, g, b)))
    ref = [out, mean, var, *vjp((jnp.asarray(cot), jnp.zeros_like(mean),
                                 jnp.zeros_like(var)))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, wt, g, b)]
    t_out, t_mean, t_var = conv3x3_bn_train(*ts, EPS)
    assert not t_mean.requires_grad and not t_var.requires_grad
    t_out.backward(torch.from_numpy(cot))
    got = [t_out.detach(), t_mean, t_var] + [t.grad for t in ts]
    names = ["out", "mean", "var", "dx", "dw", "dgamma", "dbeta"]
    for name, r, o in zip(names, ref, got):
        _close(o.numpy(), np.asarray(r), F32_RTOL if name in
               ("out", "mean", "var") else GRAD_RTOL, name)


@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_module_train_and_eval_match_reference(with_bias):
    cin, cout = 6, 10
    jmod = JaxFusedConv3x3BN(cin, cout, with_bias=with_bias)
    tmod = FusedConv3x3BN(cin, cout, with_bias=with_bias)
    p = flatten_tree(jmod.parameter_tree())
    p["gamma"] = _rand(cout, seed=4) * 0.1 + 1.0
    p["beta"] = _rand(cout, seed=5) * 0.1
    bufs = {"running_mean": _rand(cout, seed=6) * 0.1,
            "running_var": np.abs(_rand(cout, seed=8)) + 0.5}
    jmod.load_parameter_tree({k: jnp.asarray(v) for k, v in p.items()})
    jmod.load_buffer_tree({k: jnp.asarray(v) for k, v in bufs.items()})
    import_tree_state(tmod, p, bufs)
    x = _rand(2, 5, 7, cin, seed=9)
    ref = np.asarray(jmod.forward(jnp.asarray(x)))
    got = tmod(torch.from_numpy(x))
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
