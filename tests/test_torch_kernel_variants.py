"""Which variant of kernels K1, K2, K3, K5 and K6 a CUDA tensor takes, on
the CPU.

Each kernel has an "mma" variant on the tensor cores in bf16; K1 and K6
have a "tf32x3" variant on the tensor cores at f32 accuracy; K2, K3, K5
and K6 have an "fma" one on the CUDA cores. ``matmul_bn.kernel_variant``,
``conv3x3_bn.kernel_variant``, ``flash_attention.kernel_variant`` (K1),
``flash_attention.bwd_kernel_variant`` and ``flash_attention.bwd_variant``
(K2, K3) are plain functions, so the routing is tested here: every bf16
1x1 and 3x3 conv of ResNet-50 and every bf16 attention, forward and
backward, takes "mma"; every f32 3x3 conv of ResNet-50 and VGG-16 but
VGG's first (Cin = 3) and every f32 attention forward take "tf32x3"; f32
1x1 convs, f32 attention backward and the ragged shapes take "fma". On
CPU tensors the wrappers (K4's too) run their plain versions and count no
launch of any variant.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import conv3x3_bn, flash_attention, int8_matmul, matmul_bn


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread for this file's tests, restored after each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

WIDTHS, REPS = (64, 128, 256, 512), (3, 4, 6, 3)


def resnet50_3x3_shapes(b):
    """The distinct stride-1 3x3 conv shapes (N, H, W, Cin, Cout) of
    ResNet-50's fused pairs at batch b (as ``chip_smoke.py`` lists them)."""
    threes, hw = [], 56
    for stage, (width, reps) in enumerate(zip(WIDTHS, REPS)):
        for i in range(reps):
            stride = 2 if stage > 0 and i == 0 else 1
            if stride == 1:
                threes.append((b, hw, hw, width, width))
            hw //= stride
    return list(dict.fromkeys(threes))


def resnet50_1x1_shapes(b):
    """The distinct (M, K, N) of ResNet-50's fused 1x1 convs at batch b,
    a stride-2 projection's M after the module's subsample (as
    ``chip_smoke.py`` lists them)."""
    ones, hw, n_in = [], 56, 64
    for stage, (width, reps) in enumerate(zip(WIDTHS, REPS)):
        for i in range(reps):
            stride = 2 if stage > 0 and i == 0 else 1
            out_hw = hw // stride
            ones.append((b * hw * hw, n_in, width))
            ones.append((b * out_hw * out_hw, width, 4 * width))
            if i == 0:
                ones.append((b * out_hw * out_hw, n_in, 4 * width))
            hw, n_in = out_hw, 4 * width
    return list(dict.fromkeys(ones))


def _mm_args(m, k, n, dtype):
    """x (m, K) as a zero-stride view (no memory however large m is) and w
    (K, N)."""
    return (torch.zeros(1, dtype=dtype).expand(m, k),
            torch.zeros((k, n), dtype=dtype))


def test_the_resnet50_1x1_shape_list():
    shapes = resnet50_1x1_shapes(256)
    assert len(shapes) == 15
    assert shapes[:4] == [(802816, 64, 64), (802816, 64, 256),
                          (802816, 256, 64), (802816, 256, 128)]
    assert (12544, 512, 2048) in shapes and (200704, 256, 512) in shapes
    assert {(k, n) for _, k, n in shapes} == {
        (k, n) for _, k, n in resnet50_1x1_shapes(32)}


@pytest.mark.parametrize("b", [32, 256])
def test_every_resnet50_bf16_1x1_takes_mma(b):
    for shape in resnet50_1x1_shapes(b):
        assert matmul_bn.kernel_variant(*_mm_args(*shape, torch.bfloat16)) \
            == "mma", shape
        assert matmul_bn.kernel_variant(*_mm_args(*shape, torch.float32)) \
            == "fma", shape


@pytest.mark.parametrize("m, k, n, want", [
    (257, 3, 5, "fma"), (1000, 12, 70, "fma"), (300, 48, 100, "fma"),
    (64, 16, 128, "mma"), (512, 64, 256, "mma"), (7, 8, 70, "fma"),
    (7, 12, 64, "fma")])
def test_ragged_1x1_take_fma(m, k, n, want):
    # the rule: bf16 with K and N multiples of 8 takes mma (the reference
    # tests' K=3 and K=12, and N=70 or 100, do not)
    assert matmul_bn.kernel_variant(*_mm_args(m, k, n, torch.bfloat16)) == want
    assert matmul_bn.kernel_variant(*_mm_args(m, k, n, torch.float32)) == "fma"


def _conv_args(n, h, w, cin, cout, dtype):
    return (torch.zeros((n, h, w, cin), dtype=dtype),
            torch.zeros((3, 3, cin, cout), dtype=dtype))


def test_the_resnet50_shape_list():
    assert resnet50_3x3_shapes(32) == [(32, 56, 56, 64, 64),
                                       (32, 28, 28, 128, 128),
                                       (32, 14, 14, 256, 256),
                                       (32, 7, 7, 512, 512)]


@pytest.mark.parametrize("b", [32, 256])
def test_every_resnet50_bf16_conv_takes_mma(b):
    for shape in resnet50_3x3_shapes(b):
        x, w = _conv_args(*shape, torch.bfloat16)
        assert conv3x3_bn.kernel_variant(x, w) == "mma", shape
        x, w = _conv_args(*shape, torch.float32)
        assert conv3x3_bn.kernel_variant(x, w) == "tf32x3", shape


@pytest.mark.parametrize("cin", [3, 4, 8])
@pytest.mark.parametrize("cout", [2, 16, 70])
def test_ragged_convs_take_fma(cin, cout):
    # the rule: Cin and Cout multiples of 8 take mma (bf16) or tf32x3
    # (f32), so of these only Cin=8 -> Cout=16 does
    aligned = (cin, cout) == (8, 16)
    x, w = _conv_args(2, 5, 7, cin, cout, torch.bfloat16)
    assert conv3x3_bn.kernel_variant(x, w) == ("mma" if aligned else "fma")
    x, w = _conv_args(2, 5, 7, cin, cout, torch.float32)
    assert conv3x3_bn.kernel_variant(x, w) == ("tf32x3" if aligned
                                               else "fma")


def vgg16_3x3_shapes(b):
    """(N, H, W, Cin, Cout) of VGG-16's 13 convs at batch b, in model
    order (as ``chip_smoke.py`` lists them)."""
    from bigdl_tpu_torch.models.vgg import _IMAGENET_CFG
    shapes, n_in, hw = [], 3, 224
    for v in _IMAGENET_CFG[16]:
        if v == "M":
            hw = (hw + 1) // 2
        else:
            shapes.append((b, hw, hw, n_in, v))
            n_in = v
    return shapes


def test_vgg16_f32_convs_take_tf32x3_but_the_first():
    shapes = vgg16_3x3_shapes(2)
    assert len(shapes) == 13 and shapes[0][3] == 3
    got = [conv3x3_bn.kernel_variant(*_conv_args(*s, torch.float32))
           for s in shapes]
    assert got == ["fma"] + ["tf32x3"] * 12


@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_flash_variant_by_dtype(d):
    q = torch.zeros((2, 9, 3, d), dtype=torch.bfloat16)
    flash_attention.check_args(q, q, q)
    assert flash_attention.kernel_variant(q) == "mma"
    assert flash_attention.bwd_kernel_variant(q) == "mma"
    q = q.float()
    flash_attention.check_args(q, q, q)
    # K1 takes the tensor cores in f32 too; K2 and K3 stay on the CUDA cores
    assert flash_attention.kernel_variant(q) == "tf32x3"
    assert flash_attention.bwd_kernel_variant(q) == "fma"


def _counts():
    return (conv3x3_bn.LAUNCHES.value, conv3x3_bn.LAUNCHES_MMA.value,
            conv3x3_bn.LAUNCHES_TF32.value,
            flash_attention.LAUNCHES.value, flash_attention.LAUNCHES_MMA.value,
            flash_attention.LAUNCHES_TF32.value,
            matmul_bn.LAUNCHES.value, matmul_bn.LAUNCHES_MMA.value,
            int8_matmul.LAUNCHES.value)


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(0)
    before = _counts()
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 16), np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 16, 8), np.float32))
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    assert conv3x3_bn.kernel_variant(xb, wb) == "mma"
    got = conv3x3_bn.conv3x3_with_stats(xb, wb)
    ref = conv3x3_bn.conv3x3_with_stats_plain(xb, wb)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 7, 2, 64), np.float32))
               .to(torch.bfloat16) for _ in range(3))
    o, lse = flash_attention.flash_attention_with_lse(q, k, v, causal=True)
    po, plse = flash_attention.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    # the f32 inputs whose CUDA twins take the tf32x3 variants
    assert conv3x3_bn.kernel_variant(x, w) == "tf32x3"
    got = conv3x3_bn.conv3x3_with_stats(x, w)
    ref = conv3x3_bn.conv3x3_with_stats_plain(x, w)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    qf, kf, vf = (t.float() for t in (q, k, v))
    assert flash_attention.kernel_variant(qf) == "tf32x3"
    o, lse = flash_attention.flash_attention_with_lse(qf, kf, vf, causal=True)
    po, plse = flash_attention.flash_attention_plain(qf, kf, vf, causal=True)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    x2 = torch.from_numpy(rng.standard_normal((37, 16), np.float32))
    w2 = torch.from_numpy(rng.standard_normal((16, 24), np.float32))
    x2b, w2b = x2.to(torch.bfloat16), w2.to(torch.bfloat16)
    assert matmul_bn.kernel_variant(x2b, w2b) == "mma"
    got = matmul_bn.matmul_with_stats(x2b, w2b)
    ref = matmul_bn.matmul_with_stats_plain(x2b, w2b)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    wq = torch.from_numpy(rng.integers(-128, 128, (24, 16), dtype=np.int8))
    scale = torch.from_numpy(rng.random((24, 1), np.float32))
    y = int8_matmul.int8_matmul(x2[:4], wq, scale, None, torch.float32)
    assert torch.equal(y, int8_matmul.int8_matmul_plain(x2[:4], wq,
                                                        scale.reshape(24)))
    assert _counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_bn.conv3x3_with_stats_kernel(xb, wb)
    with pytest.raises(ValueError, match="CUDA"):
        matmul_bn.matmul_with_stats_kernel(x2b, w2b)
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul.int8_matmul_kernel(x2b[:4], wq, scale.reshape(24))


def _view_at(shape, dtype, offset):
    """A contiguous view of ``shape`` that starts ``offset`` elements into
    a fresh buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("offset", [1, 4])
def test_conv_mma_refuses_a_misaligned_view(which, offset):
    # the mma and tf32x3 variants read x and w with 16-byte copies: a view
    # that starts 2 or 8 bytes (bf16), 4 or 8 bytes (f32) into its buffer
    # is refused before any launch
    shapes = ((2, 5, 7, 16), (3, 3, 16, 8))
    for dt, variant in ((torch.bfloat16, "mma"), (torch.float32, "tf32x3")):
        skip = offset if dt == torch.bfloat16 else max(1, offset // 2)
        args = [_view_at(s, dt, skip if i == which else 0)
                for i, s in enumerate(shapes)]
        assert args[which].is_contiguous() and args[which].data_ptr() % 16
        assert conv3x3_bn.kernel_variant(*args) == variant
        with pytest.raises(ValueError, match="16-byte"):
            conv3x3_bn.conv3x3_with_stats_kernel(*args)
    # the fma variant (Cin = 3) has no such rule: f32 gets as far as the
    # device check
    shapes = ((2, 5, 7, 3), (3, 3, 3, 8))
    args = [_view_at(s, torch.float32, offset if i == which else 0)
            for i, s in enumerate(shapes)]
    assert conv3x3_bn.kernel_variant(*args) == "fma"
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_bn.conv3x3_with_stats_kernel(*args)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("offset", [1, 4])
def test_matmul_mma_refuses_a_misaligned_view(which, offset):
    # K5's mma variant reads x and w with 16-byte copies: a view that starts
    # 2 or 8 bytes into its buffer is refused before any device check
    shapes = ((37, 16), (16, 24))
    args = [_view_at(s, torch.bfloat16, offset if i == which else 0)
            for i, s in enumerate(shapes)]
    assert args[which].is_contiguous() and args[which].data_ptr() % 16
    assert matmul_bn.kernel_variant(*args) == "mma"
    with pytest.raises(ValueError, match="16-byte"):
        matmul_bn.matmul_with_stats_kernel(*args)
    # the fma variant has no such rule: f32 gets as far as the device check
    args = [_view_at(s, torch.float32, offset if i == which else 0)
            for i, s in enumerate(shapes)]
    with pytest.raises(ValueError, match="CUDA"):
        matmul_bn.matmul_with_stats_kernel(*args)
    aligned = [_view_at(s, torch.bfloat16, 0) for s in shapes]
    with pytest.raises(ValueError, match="CUDA"):
        matmul_bn.matmul_with_stats_kernel(*aligned)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_mma_refuses_a_misaligned_view(which):
    # both K1 variants, mma (bf16) and tf32x3 (f32), read q, k and v with
    # 16-byte copies: a view 2 or 4 bytes into its buffer is refused
    for dt, variant in ((torch.bfloat16, "mma"), (torch.float32, "tf32x3")):
        qkv = [_view_at((1, 9, 2, 64), dt, 1 if i == which else 0)
               for i in range(3)]
        assert flash_attention.kernel_variant(qkv[0]) == variant
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention._flash_fwd_cuda(*qkv, True, 0.125)
        aligned = [_view_at((1, 9, 2, 64), dt, 0) for _ in range(3)]
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention._flash_fwd_cuda(*aligned, True, 0.125)


def _bwd_args(dtype, d=64, misaligned=None):
    """(q, k, v, g_o, lse, delta) of B=1 S=9 N=2 as the backward kernels
    take them; ``misaligned`` (0-3) starts that one 2 bytes (bf16) or 4
    bytes (f32) into its buffer."""
    qkvg = [_view_at((1, 9, 2, d), dtype, int(i == misaligned))
            for i in range(4)]
    return (*qkvg, torch.zeros((1, 2, 9)), torch.zeros((1, 2, 9)))


@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_flash_bwd_variant_by_dtype(d):
    # both head dims take mma in bf16: D=128 has no fma fallback
    assert flash_attention.bwd_variant(*_bwd_args(torch.bfloat16, d)) == "mma"
    assert flash_attention.bwd_variant(*_bwd_args(torch.float32, d)) == "fma"


@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_flash_bwd_mma_refuses_a_misaligned_view(kernel, which):
    # q, k, v or g_o 2 bytes into its buffer: refused before any launch
    args = _bwd_args(torch.bfloat16, misaligned=which)
    assert args[which].is_contiguous() and args[which].data_ptr() % 16
    outs = (torch.empty_like(args[0]),) * (1 if kernel == "flash_bwd_dq" else 2)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention.bwd_variant(*args)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention._bwd_launch(kernel, outs, *args, True, 0.125)
    # f32 takes fma, which has no such rule: it gets as far as the device
    args = _bwd_args(torch.float32, misaligned=which)
    assert flash_attention.bwd_variant(*args) == "fma"
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention._bwd_launch(kernel, outs, *args, True, 0.125)
    aligned = _bwd_args(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention._bwd_launch(kernel, outs, *aligned, True, 0.125)


def _bwd_counts():
    fa = flash_attention
    return tuple(c.value for c in (fa.LAUNCHES_DQ, fa.LAUNCHES_DQ_MMA,
                                   fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_backward_counts_no_launch(dtype):
    rng = np.random.default_rng(1)
    q, k, v, g_o = (torch.from_numpy(rng.standard_normal((1, 7, 2, 64),
                                                         np.float32))
                    .to(dtype) for _ in range(4))
    before = _bwd_counts()
    o, lse = flash_attention.flash_attention_plain(q, k, v, True, 0.125)
    args = (q, k, v, g_o, lse, flash_attention.bwd_delta(o, g_o, None), True,
            0.125)
    assert torch.equal(flash_attention.flash_bwd_dq(*args),
                       flash_attention.flash_bwd_dq_plain(*args))
    for got, want in zip(flash_attention.flash_bwd_dkv(*args),
                         flash_attention.flash_bwd_dkv_plain(*args)):
        assert torch.equal(got, want)
    qt = q.clone().requires_grad_()
    flash_attention.flash_attention(qt, k, v, causal=True).backward(g_o)
    assert qt.grad is not None and qt.grad.dtype == dtype
    assert _bwd_counts() == before
