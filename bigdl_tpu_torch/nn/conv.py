"""Convolutions (counterpart of ``bigdl_tpu/nn/conv.py``:
``SpatialConvolution``, ``SpaceToDepthConv7`` and ``stem_conv7`` are
ported).

Layout is the reference's: activations NHWC, weights HWIO
``(kh, kw, in / groups, out)`` as ``parameter_tree()`` holds them, so
weights carry across with no transposes. These are plain convolutions in
the reference (XLA, not Pallas), so here they are ``F.conv2d`` on
``x.permute(0, 3, 1, 2)`` (a channels-last view, which cuDNN takes without
a copy) and ``w.permute(3, 2, 0, 1)``; the NCHW result is viewed back as
NHWC. A bias is added after the conv, as in the reference.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.precision import match_compute


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                padding=(0, 0), groups: int = 1) -> torch.Tensor:
    """NHWC x convolved with HWIO w; NHWC out. ``stride`` and ``padding``
    are (h, w)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=tuple(stride), padding=tuple(padding),
                   groups=groups)
    return out.permute(0, 2, 3, 1)


class SpatialConvolution(Module):
    """2-D convolution (reference ``SpatialConvolution``), constructor
    order as the reference's; ``generator`` draws the initial weights."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 with_bias: bool = True, init_method: str = "default", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError("planes must divide into n_group groups")
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.with_bias = with_bias
        fan_in = kernel_h * kernel_w * n_input_plane // n_group
        fan_out = kernel_h * kernel_w * n_output_plane // n_group
        self.weight = torch.nn.Parameter(init.conv_weight(
            init_method, (kernel_h, kernel_w, n_input_plane // n_group,
                          n_output_plane), fan_in, fan_out, generator))
        if with_bias:
            self.bias = torch.nn.Parameter(
                init.default_init((n_output_plane,), fan_in, generator))

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


class SpaceToDepthConv7(Module):
    """The 7x7 / stride-2 / pad-3 stem conv computed as a 4x4 / stride-1
    conv over 2x2 space-to-depth packed input (reference
    ``SpaceToDepthConv7``; the same function as the plain conv).

    The parameter is the reference-shaped ``(7, 7, C, O)`` "weight"; every
    forward scatters it into the packed ``(4, 4, 4C, O)`` layout (pad 7x7
    to 8x8 at offset 1, regroup), exactly as the reference does. Odd
    spatial sizes get one zero row / column first; the packed conv pads
    (2, 1) on each spatial dim."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 with_bias: bool = True, init_method: str = "default", *,
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
        self.weight = torch.nn.Parameter(init.conv_weight(
            init_method, (7, 7, n_input_plane, n_output_plane), fan_in,
            fan_out, generator))
        if with_bias:
            self.bias = torch.nn.Parameter(
                init.default_init((n_output_plane,), fan_in, generator))

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
               generator: Optional[torch.Generator] = None) -> Module:
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
