"""Convolutions (counterpart of ``bigdl_tpu/nn/conv.py``; every class is
ported).

Layout is the reference's: activations NHWC, weights HWIO
``(kh, kw, in / groups, out)`` as ``parameter_tree()`` holds them, so
weights carry across with no transposes. These are plain convolutions in
the reference (XLA, not Pallas), so here they are ``F.conv2d`` on
``x.permute(0, 3, 1, 2)`` (a channels-last view, which cuDNN takes without
a copy) and ``w.permute(3, 2, 0, 1)``; the NCHW result is viewed back as
NHWC. A bias is added after the conv, as in the reference. The dilated,
transposed (``SpatialFullConvolution``), volumetric (NDHWC, DHWIO) and
connection-table convolutions are plain ``F.conv*`` calls in the same
way; no reference kernel computes them either.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.ops.precision import match_compute
from bigdl_tpu_torch.utils.rng import RandomGenerator


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                padding=(0, 0), groups: int = 1) -> torch.Tensor:
    """NHWC x convolved with HWIO w; NHWC out. ``stride`` and ``padding``
    are (h, w)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=tuple(stride), padding=tuple(padding),
                   groups=groups)
    return out.permute(0, 2, 3, 1)


class SpatialConvolution(TensorModule):
    """2-D convolution (reference ``SpatialConvolution``), constructor
    order as the reference's; ``w_regularizer`` / ``b_regularizer`` ride on
    the weight and bias; ``generator`` draws the initial weights."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, init_method: str = "default", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError("planes must divide into n_group groups")
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.with_bias = with_bias
        self.init_method = init_method
        fan_in = kernel_h * kernel_w * n_input_plane // n_group
        fan_out = kernel_h * kernel_w * n_output_plane // n_group
        self.register_parameter("weight", init.conv_weight(
            init_method, (kernel_h, kernel_w, n_input_plane // n_group,
                          n_output_plane), fan_in, fan_out, generator),
            w_regularizer)
        if with_bias:
            self.register_parameter(
                "bias", init.default_init((n_output_plane,), fan_in,
                                          generator), b_regularizer)

    def forward(self, input):
        squeeze = input.dim() == 3
        if squeeze:  # unbatched (H, W, C)
            input = input[None]
        x = match_compute(input, self.weight)
        out = conv2d_nhwc(x, self.weight, (self.stride_h, self.stride_w),
                          (self.pad_h, self.pad_w), self.n_group)
        if self.with_bias:
            out = out + self.bias
        return out[0] if squeeze else out


class SpatialShareConvolution(SpatialConvolution):
    """reference ``SpatialShareConvolution``: the reference's buffer-sharing
    variant, the same function as ``SpatialConvolution``."""


class SpaceToDepthConv7(TensorModule):
    """The 7x7 / stride-2 / pad-3 stem conv computed as a 4x4 / stride-1
    conv over 2x2 space-to-depth packed input (reference
    ``SpaceToDepthConv7``; the same function as the plain conv).

    The parameter is the reference-shaped ``(7, 7, C, O)`` "weight"; every
    forward scatters it into the packed ``(4, 4, 4C, O)`` layout (pad 7x7
    to 8x8 at offset 1, regroup), exactly as the reference does. Odd
    spatial sizes get one zero row / column first; the packed conv pads
    (2, 1) on each spatial dim."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 with_bias: bool = True, init_method: str = "default",
                 w_regularizer=None, b_regularizer=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.with_bias = with_bias
        self.kernel_h = self.kernel_w = 7
        self.stride_h = self.stride_w = 2
        self.pad_h = self.pad_w = 3
        self.n_group = 1
        fan_in, fan_out = 49 * n_input_plane, 49 * n_output_plane
        self.register_parameter("weight", init.conv_weight(
            init_method, (7, 7, n_input_plane, n_output_plane), fan_in,
            fan_out, generator), w_regularizer)
        if with_bias:
            self.register_parameter(
                "bias", init.default_init((n_output_plane,), fan_in,
                                          generator), b_regularizer)

    def forward(self, input):
        squeeze = input.dim() == 3
        if squeeze:
            input = input[None]
        x = match_compute(input, self.weight)
        if x.shape[-1] != self.n_input_plane:
            raise ValueError(f"SpaceToDepthConv7({self.n_input_plane}) got "
                             f"input {tuple(x.shape)}")
        pad_h, pad_w = x.shape[1] % 2, x.shape[2] % 2
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        n, h, w, c = x.shape
        o = self.n_output_plane
        # pack 2x2 spatial blocks into channels, order (di, dj, c)
        xp = (x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
              .reshape(n, h // 2, w // 2, 4 * c))
        # scatter the 7x7 weight into the packed 4x4 layout (same order)
        w8 = F.pad(self.weight.to(x.dtype), (0, 0, 0, 0, 1, 0, 1, 0))
        w4 = (w8.reshape(4, 2, 4, 2, c, o).permute(0, 2, 1, 3, 4, 5)
              .reshape(4, 4, 4 * c, o))
        xp = F.pad(xp, (0, 0, 2, 1, 2, 1))
        out = conv2d_nhwc(xp, w4)
        if self.with_bias:
            out = out + self.bias
        return out[0] if squeeze else out


def stem_conv7(n_in: int, n_out: int, with_bias: bool = True,
               init_method: str = "default", name: str = "", *,
               generator: Optional[torch.Generator] = None) -> TensorModule:
    """The 7x7 / s2 / p3 ImageNet stem: ``SpaceToDepthConv7`` unless the
    environment sets ``BIGDL_TPU_NO_S2D`` (any non-empty value), which
    restores the plain ``SpatialConvolution``. Both hold one "weight"
    (7, 7, C, O) [+ "bias"], so their weights interchange. A non-empty
    ``name`` is set on the module."""
    if os.environ.get("BIGDL_TPU_NO_S2D"):
        mod = SpatialConvolution(n_in, n_out, 7, 7, 2, 2, 3, 3,
                                 with_bias=with_bias,
                                 init_method=init_method, generator=generator)
    else:
        mod = SpaceToDepthConv7(n_in, n_out, with_bias=with_bias,
                                init_method=init_method, generator=generator)
    return mod.set_name(name) if name else mod


def _batched(input, rank: int):
    """``(input with a batch dim, whether one was added)``."""
    if input.dim() == rank - 1:
        return input[None], True
    return input, False


class SpatialDilatedConvolution(TensorModule):
    """Atrous 2-D convolution (reference ``SpatialDilatedConvolution``):
    kernel taps ``dilation`` pixels apart."""

    def __init__(self, n_input_plane: int, n_output_plane: int, kw: int,
                 kh: int, dw: int = 1, dh: int = 1, pad_w: int = 0,
                 pad_h: int = 0, dilation_w: int = 1, dilation_h: int = 1,
                 w_regularizer=None, b_regularizer=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        fan_in = kh * kw * n_input_plane
        self.register_parameter("weight", init.default_init(
            (kh, kw, n_input_plane, n_output_plane), fan_in, generator),
            w_regularizer)
        self.register_parameter("bias", init.default_init(
            (n_output_plane,), fan_in, generator), b_regularizer)

    def forward(self, input):
        x, squeeze = _batched(input, 4)
        out = F.conv2d(x.permute(0, 3, 1, 2), self.weight.permute(3, 2, 0, 1),
                       stride=(self.dh, self.dw),
                       padding=(self.pad_h, self.pad_w),
                       dilation=(self.dilation_h, self.dilation_w))
        out = out.permute(0, 2, 3, 1) + self.bias
        return out[0] if squeeze else out


class SpatialFullConvolution(TensorModule):
    """Transposed ("full") 2-D convolution (reference
    ``SpatialFullConvolution``): the adjoint of the strided convolution
    whose HWIO weight is this one's (kh, kw, n_output / n_group,
    n_input). Output size ``(in - 1) * stride - 2 * pad + kernel + adj``;
    ``adj`` must be smaller than the stride."""

    def __init__(self, n_input_plane: int, n_output_plane: int, kw: int,
                 kh: int, dw: int = 1, dh: int = 1, pad_w: int = 0,
                 pad_h: int = 0, adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 w_regularizer=None, b_regularizer=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not (adj_w < dw and adj_h < dh):
            raise ValueError("adj must be smaller than stride")
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.with_bias = not no_bias
        fan_in = kh * kw * n_output_plane // n_group
        self.register_parameter("weight", init.default_init(
            (kh, kw, n_output_plane // n_group, n_input_plane), fan_in,
            generator), w_regularizer)
        if self.with_bias:
            self.register_parameter("bias", init.zeros((n_output_plane,)),
                                    b_regularizer)

    def forward(self, input):
        x, squeeze = _batched(input, 4)
        out = F.conv_transpose2d(
            x.permute(0, 3, 1, 2), self.weight.permute(3, 2, 0, 1),
            stride=(self.dh, self.dw), padding=(self.pad_h, self.pad_w),
            output_padding=(self.adj_h, self.adj_w), groups=self.n_group)
        out = out.permute(0, 2, 3, 1)
        if self.with_bias:
            out = out + self.bias
        return out[0] if squeeze else out


class VolumetricConvolution(TensorModule):
    """3-D convolution over NDHWC with a DHWIO weight (reference
    ``VolumetricConvolution``; the reference's (kT, kW, kH) argument
    order)."""

    def __init__(self, n_input_plane: int, n_output_plane: int, k_t: int,
                 k_w: int, k_h: int, d_t: int = 1, d_w: int = 1,
                 d_h: int = 1, pad_t: int = 0, pad_w: int = 0,
                 pad_h: int = 0, with_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.k_t, self.k_w, self.k_h = k_t, k_w, k_h
        self.d_t, self.d_w, self.d_h = d_t, d_w, d_h
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.with_bias = with_bias
        fan_in = k_t * k_h * k_w * n_input_plane
        self.weight = torch.nn.Parameter(init.default_init(
            (k_t, k_h, k_w, n_input_plane, n_output_plane), fan_in,
            generator))
        if with_bias:
            self.bias = torch.nn.Parameter(init.default_init(
                (n_output_plane,), fan_in, generator))

    def forward(self, input):
        x, squeeze = _batched(input, 5)
        out = F.conv3d(x.permute(0, 4, 1, 2, 3),
                       self.weight.permute(4, 3, 0, 1, 2),
                       stride=(self.d_t, self.d_h, self.d_w),
                       padding=(self.pad_t, self.pad_h, self.pad_w))
        out = out.permute(0, 2, 3, 4, 1)
        if self.with_bias:
            out = out + self.bias
        return out[0] if squeeze else out


class SpatialConvolutionMap(TensorModule):
    """Convolution over an explicit connection table (reference
    ``SpatialConvolutionMap``): ``conn_table`` is (pairs, 2) of 1-based
    (input plane, output plane); the dense HWIO weight is multiplied by the
    table's 0/1 ``mask`` buffer at every forward, so an unlisted pair has
    neither output nor gradient."""

    def __init__(self, conn_table, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1, pad_w: int = 0,
                 pad_h: int = 0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        conn = np.asarray(conn_table, dtype=np.int64)
        self.n_input_plane = int(conn[:, 0].max())
        self.n_output_plane = int(conn[:, 1].max())
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        mask = np.zeros((self.n_input_plane, self.n_output_plane), np.float32)
        mask[conn[:, 0] - 1, conn[:, 1] - 1] = 1.0
        self.register_buffer("mask", torch.from_numpy(mask[None, None]))
        fan_in = max(1, int(conn.shape[0] / self.n_output_plane
                            * kernel_w * kernel_h))
        self.weight = torch.nn.Parameter(init.default_init(
            (kernel_h, kernel_w, self.n_input_plane, self.n_output_plane),
            fan_in, generator))
        self.bias = torch.nn.Parameter(init.default_init(
            (self.n_output_plane,), fan_in, generator))

    @staticmethod
    def full(n_in: int, n_out: int) -> np.ndarray:
        return np.stack(np.meshgrid(np.arange(1, n_in + 1),
                                    np.arange(1, n_out + 1)), -1).reshape(-1, 2)

    @staticmethod
    def one_to_one(n_features: int) -> np.ndarray:
        idx = np.arange(1, n_features + 1)
        return np.stack([idx, idx], axis=1)

    @staticmethod
    def random(n_in: int, n_out: int, n_to: int) -> np.ndarray:
        """``n_to`` random inputs for each output, drawn from the port's
        ``RandomGenerator.RNG()``."""
        rng = RandomGenerator.RNG()
        pairs = []
        for o in range(1, n_out + 1):
            pairs.extend((int(i), o) for i in rng.randperm(n_in)[:n_to])
        return np.asarray(pairs)

    def forward(self, input):
        x, squeeze = _batched(input, 4)
        out = conv2d_nhwc(x, self.weight * self.mask,
                          (self.stride_h, self.stride_w),
                          (self.pad_h, self.pad_w)) + self.bias
        return out[0] if squeeze else out
