"""Which variant of kernels K1 and K6 a CUDA tensor takes, on the CPU.

Both kernels have an "mma" variant on the tensor cores and an "fma" one on
the CUDA cores. ``conv3x3_bn.kernel_variant`` and
``flash_attention.kernel_variant`` are plain functions, so the routing is
tested here: every bf16 3x3 conv of ResNet-50 and every bf16 attention
takes "mma", f32 and the ragged convs take "fma". On CPU tensors the
wrappers run their plain versions and count no launch of either variant.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import conv3x3_bn, flash_attention

torch.set_num_threads(1)

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
        assert conv3x3_bn.kernel_variant(x, w) == "fma", shape


@pytest.mark.parametrize("cin", [3, 4, 8])
@pytest.mark.parametrize("cout", [2, 16, 70])
def test_ragged_convs_take_fma(cin, cout):
    # the rule: bf16 with Cin and Cout multiples of 8 takes mma, so of these
    # only Cin=8 -> Cout=16 does
    x, w = _conv_args(2, 5, 7, cin, cout, torch.bfloat16)
    want = "mma" if (cin, cout) == (8, 16) else "fma"
    assert conv3x3_bn.kernel_variant(x, w) == want
    x, w = _conv_args(2, 5, 7, cin, cout, torch.float32)
    assert conv3x3_bn.kernel_variant(x, w) == "fma"


@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_flash_variant_by_dtype(d):
    q = torch.zeros((2, 9, 3, d), dtype=torch.bfloat16)
    flash_attention.check_args(q, q, q)
    assert flash_attention.kernel_variant(q) == "mma"
    q = q.float()
    flash_attention.check_args(q, q, q)
    assert flash_attention.kernel_variant(q) == "fma"


def _counts():
    return (conv3x3_bn.LAUNCHES.value, conv3x3_bn.LAUNCHES_MMA.value,
            flash_attention.LAUNCHES.value, flash_attention.LAUNCHES_MMA.value)


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
    assert _counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_bn.conv3x3_with_stats_kernel(xb, wb)


def _view_at(shape, dtype, offset):
    """A contiguous view of ``shape`` that starts ``offset`` elements into
    a fresh buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("offset", [1, 4])
def test_conv_mma_refuses_a_misaligned_view(which, offset):
    # the mma variant reads x and w with 16-byte copies: a view that starts
    # 2 or 8 bytes into its buffer is refused before any launch
    shapes = ((2, 5, 7, 16), (3, 3, 16, 8))
    args = [_view_at(s, torch.bfloat16, offset if i == which else 0)
            for i, s in enumerate(shapes)]
    assert args[which].is_contiguous() and args[which].data_ptr() % 16
    assert conv3x3_bn.kernel_variant(*args) == "mma"
    with pytest.raises(ValueError, match="16-byte"):
        conv3x3_bn.conv3x3_with_stats_kernel(*args)
    # the fma variant has no such rule: f32 gets as far as the device check
    args = [_view_at(s, torch.float32, offset if i == which else 0)
            for i, s in enumerate(shapes)]
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_bn.conv3x3_with_stats_kernel(*args)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_mma_refuses_a_misaligned_view(which):
    qkv = [_view_at((1, 9, 2, 64), torch.bfloat16, 1 if i == which else 0)
           for i in range(3)]
    assert flash_attention.kernel_variant(qkv[0]) == "mma"
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention._flash_fwd_cuda(*qkv, True, 0.125)
    qkv = [_view_at((1, 9, 2, 64), torch.float32, 1 if i == which else 0)
           for i in range(3)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention._flash_fwd_cuda(*qkv, True, 0.125)
    aligned = [_view_at((1, 9, 2, 64), torch.bfloat16, 0) for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention._flash_fwd_cuda(*aligned, True, 0.125)
