"""Kernel K4's plain version and ``quantize_array`` against the JAX package.

``quantize_array`` must give the reference's int8 values exactly (both
round half to even). The port's ``int8_matmul`` on CPU tensors (the plain
version of kernel K4 for M <= 256) is held against the reference's
``int8_matmul`` at M <= 32, where the reference on CPU runs its Pallas
kernel in interpret mode. Tolerance with compute dtype f32: 1e-5 absolute
plus 1e-5 relative (the same exact bf16 x int8 products summed in f32 in
another order); with compute dtype bf16, one bf16 step (2^-8 relative):
both round the same f32 value.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.quantized import quantize_array as jax_quantize_array
from bigdl_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from bigdl_tpu_torch.nn.quantized import quantize_array
from bigdl_tpu_torch.ops import int8_matmul as im

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _weights(o, k, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((o, k)).astype(np.float32)
    q, s = jax_quantize_array(jnp.asarray(w), 0)
    return np.array(q), np.array(s)


@pytest.mark.parametrize("shape,axis", [((64, 48), 0), ((48, 64), -1),
                                        ((3, 3, 8, 16), -1), ((1000, 128), 0)])
def test_quantize_array_equals_reference(shape, axis):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    rq, rs = jax_quantize_array(jnp.asarray(w), axis)
    q, s = quantize_array(torch.from_numpy(w), axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_quantize_array_rounds_half_to_even():
    # amax 127 gives scale 1.0, so w / scale sits exactly on the halves
    w = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5]], np.float32)
    q, _ = quantize_array(torch.from_numpy(w), 0)
    rq, _ = jax_quantize_array(jnp.asarray(w), 0)
    assert q.numpy().tolist() == [[127, 2, -4, 0, 0, 2]]
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))


@pytest.mark.parametrize("o", [256, 1100])
@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("m,with_bias", [(1, False), (32, True)])
def test_plain_matches_reference_kernel(o, k, m, with_bias):
    q, s = _weights(o, k, seed=o + k)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal((o,)).astype(np.float32) if with_bias else None
    ref = np.asarray(jax_int8_matmul(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
        bias=None if bias is None else jnp.asarray(bias),
        compute_dtype=jnp.float32))
    got = im.int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                         torch.from_numpy(s),
                         bias=None if bias is None else torch.from_numpy(bias),
                         compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, o)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_plain_matches_reference_kernel_bf16_output():
    q, s = _weights(256, 128, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 3, 128)).astype(np.float32)
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                     jnp.asarray(s)).astype(jnp.float32))
    got = im.int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                         torch.from_numpy(s))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 256)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8, atol=0)


def test_plain_version_rounds_x_to_bf16():
    q, s = _weights(16, 32, seed=5)
    x = torch.full((1, 32), 1.0 + 2 ** -10)   # not a bf16 value
    y = im.int8_matmul_plain(x, torch.from_numpy(q), torch.from_numpy(s)[:, 0])
    want = (torch.ones(1, 32) @ torch.from_numpy(q).float().T) \
        * torch.from_numpy(s)[:, 0]
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_large_m_takes_dequantize_path_like_reference():
    q, s = _weights(64, 128, seed=6)
    x = np.random.default_rng(7).standard_normal((300, 128)).astype(np.float32)
    before = im.DEQUANT_CALLS.value
    got = im.int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                         torch.from_numpy(s), compute_dtype=torch.float32)
    assert im.DEQUANT_CALLS.value == before + 1
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                     jnp.asarray(s), compute_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_k_off_quantum_warns_once_and_dequantizes():
    q, s = _weights(8, 40, seed=8)
    x = torch.ones(2, 40)
    before = im.DEQUANT_CALLS.value
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        im.int8_matmul(x, torch.from_numpy(q), torch.from_numpy(s))
        im.int8_matmul(x, torch.from_numpy(q), torch.from_numpy(s))
    assert im.DEQUANT_CALLS.value == before + 2
    assert sum("multiple of 16" in str(w.message) for w in caught) == 1


@pytest.mark.parametrize("m,k,o,ok", [(1, 768, 32000, True), (256, 16, 1, True),
                                      (257, 768, 768, False),
                                      (4, 100, 768, False), (0, 768, 768, False)])
def test_kernel_applicable(m, k, o, ok):
    assert im.kernel_applicable(m, k, o) is ok


def test_cpu_never_counts_a_launch():
    q, s = _weights(32, 64, seed=9)
    before = im.LAUNCHES.value
    im.int8_matmul(torch.ones(4, 64), torch.from_numpy(q), torch.from_numpy(s))
    assert im.LAUNCHES.value == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "k", "contiguous"])
def test_kernel_argument_checks(bad):
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.zeros(32, 64, dtype=torch.int8)
    s = torch.ones(32)
    im.check_args(x, w, s)  # what the kernel takes
    if bad == "dtype":
        x = x.float()
    elif bad == "shape":
        s = torch.ones(31)
    elif bad == "k":
        x, w = x[:, :40].contiguous(), w[:, :40].contiguous()
    else:
        w = torch.zeros(64, 32, dtype=torch.int8).T
    with pytest.raises(ValueError):
        im.check_args(x, w, s)
