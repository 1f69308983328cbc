"""Pooling layers (counterpart of ``bigdl_tpu/nn/pooling.py``; every class
is ported).

Layout is channels-last (N, H, W, C), or (H, W, C) unbatched; volumetric
pooling takes (N, D, H, W, C). The
reference pads each spatial dim by ``(lo, hi)`` from ``_pool_padding``
(Torch's floor or ceil output size) and reduces windows; here the padded
NHWC input is viewed as a channels-last NCHW tensor for PyTorch's pooling.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module, TensorModule
from bigdl_tpu_torch.utils.table import elements


def _pool_padding(in_size: int, k: int, stride: int, pad: int,
                  ceil_mode: bool):
    """(lo, hi) padding giving Torch floor/ceil output-size semantics (a
    copy of the reference's ``_pool_padding``)."""
    if ceil_mode:
        out = int(math.ceil((in_size + 2 * pad - k) / stride)) + 1
        # Torch: the last window must start inside the (left-padded) input
        if pad > 0 and (out - 1) * stride >= in_size + pad:
            out -= 1
    else:
        out = (in_size + 2 * pad - k) // stride + 1
    needed = max(0, (out - 1) * stride + k - in_size - pad)
    return pad, needed


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _pad_hw(x: torch.Tensor, ph, pw, value: float) -> torch.Tensor:
    """NHWC x padded by (lo, hi) ``ph`` on H and ``pw`` on W."""
    if not any(ph + pw):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value)


class _CeilModePooling(TensorModule):
    """Fluent ``ceil()`` / ``floor()`` output-size mode."""

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def _paddings(self, h: int, w: int):
        return (_pool_padding(h, self.kh, self.dh, self.pad_h, self.ceil_mode),
                _pool_padding(w, self.kw, self.dw, self.pad_w, self.ceil_mode))


class SpatialMaxPooling(_CeilModePooling):
    """2-D max pooling, padding with -inf (reference ``SpatialMaxPooling``).

    Where PyTorch's symmetric padding gives the reference's windows and
    output size (ResNet's 3x3/s2/p1 pool on an even input, for one), the
    pool runs on the input as it is; otherwise the input is padded with
    -inf by the reference's (lo, hi) first."""

    def __init__(self, kw: int, kh: int, dw: int = None, dh: int = None,
                 pad_w: int = 0, pad_h: int = 0):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False

    def _symmetric_fits(self, size: int, k: int, d: int, pad: int, lo_hi):
        # the same first window and output count, and no window that the
        # reference's hi padding would cut short
        out_ref = (size + lo_hi[0] + lo_hi[1] - k) // d + 1
        return (2 * pad <= k and lo_hi[1] <= pad
                and (size + 2 * pad - k) // d + 1 == out_ref)

    def forward(self, input):
        squeeze = input.dim() == 3
        if squeeze:
            input = input[None]
        _, h, w, _ = input.shape
        ph, pw = self._paddings(h, w)
        if (self._symmetric_fits(h, self.kh, self.dh, self.pad_h, ph)
                and self._symmetric_fits(w, self.kw, self.dw, self.pad_w, pw)):
            out = F.max_pool2d(_nchw(input), (self.kh, self.kw),
                               (self.dh, self.dw), (self.pad_h, self.pad_w))
        else:
            x = _pad_hw(input, ph, pw, float("-inf"))
            out = F.max_pool2d(_nchw(x), (self.kh, self.kw), (self.dh, self.dw))
        out = _nhwc(out)
        return out[0] if squeeze else out


class SpatialAveragePooling(_CeilModePooling):
    """2-D average pooling (reference ``SpatialAveragePooling``): window
    sums over the zero-padded input, divided by ``kh * kw``
    (``count_include_pad``), by the count of real elements, or not at all
    (``divide=False``)."""

    def __init__(self, kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0, ceil_mode: bool = False,
                 count_include_pad: bool = True, divide: bool = True):
        super().__init__()
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide

    def _window_sums(self, x: torch.Tensor, ph, pw) -> torch.Tensor:
        x = _pad_hw(x, ph, pw, 0.0)
        return _nhwc(F.avg_pool2d(_nchw(x), (self.kh, self.kw),
                                  (self.dh, self.dw), divisor_override=1))

    def forward(self, input):
        squeeze = input.dim() == 3
        if squeeze:
            input = input[None]
        _, h, w, _ = input.shape
        ph, pw = self._paddings(h, w)
        out = self._window_sums(input, ph, pw)
        if self.divide:
            if self.count_include_pad:
                out = out / (self.kh * self.kw)
            else:
                ones = torch.ones((1, h, w, 1), dtype=input.dtype,
                                  device=input.device)
                out = out / self._window_sums(ones, ph, pw)
        return out[0] if squeeze else out


class VolumetricMaxPooling(TensorModule):
    """3-D max pooling over (N,) D, H, W, C (reference
    ``VolumetricMaxPooling``): strides default to the kernel, padding is
    -inf, output sizes are Torch's floor rule."""

    def __init__(self, kt: int, kw: int, kh: int, dt: int = None,
                 dw: int = None, dh: int = None, pad_t: int = 0,
                 pad_w: int = 0, pad_h: int = 0):
        super().__init__()
        self.kt, self.kw, self.kh = kt, kw, kh
        self.dt, self.dw, self.dh = dt or kt, dw or kw, dh or kh
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h

    def forward(self, input):
        squeeze = input.dim() == 4
        x = input[None] if squeeze else input
        _, d, h, w, _ = x.shape
        pt = _pool_padding(d, self.kt, self.dt, self.pad_t, False)
        ph = _pool_padding(h, self.kh, self.dh, self.pad_h, False)
        pw = _pool_padding(w, self.kw, self.dw, self.pad_w, False)
        if any(pt + ph + pw):
            x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1], pt[0], pt[1]),
                      value=float("-inf"))
        out = F.max_pool3d(x.permute(0, 4, 1, 2, 3),
                           (self.kt, self.kh, self.kw),
                           (self.dt, self.dh, self.dw))
        out = out.permute(0, 2, 3, 4, 1)
        return out[0] if squeeze else out


class RoiPooling(Module):
    """Region-of-interest max pooling (reference ``RoiPooling``).

    Input: the table {data (N, H, W, C), rois (R, 5)}, each roi
    ``[batch, x1, y1, x2, y2]`` in image coordinates; output (R, pooled_h,
    pooled_w, C). The batch entry is read as the reference reads it: as
    a 0-based index into ``data``, a negative one counting from the end,
    clamped into [0, N - 1]. The corners are scaled by ``spatial_scale``
    and rounded; bin (py, px) covers rows ``[floor(py * bin_h),
    ceil((py + 1) * bin_h)) + y1`` and the columns likewise, cut to the
    image; an empty bin gives 0. The bins' maxima are taken one bin row
    and one bin column at a time over every roi at once (max over the
    columns, then over the rows): no loop over the rois and no host read
    of their values."""

    def __init__(self, pooled_w: int, pooled_h: int, spatial_scale: float):
        super().__init__()
        self.pooled_w, self.pooled_h = pooled_w, pooled_h
        self.spatial_scale = spatial_scale

    def forward(self, input):
        data, rois = elements(input)[:2]
        n, h, w, c = data.shape
        rois = rois.to(device=data.device, dtype=torch.float32)
        b = rois[:, 0].to(torch.int64)
        b = torch.where(b < 0, b + n, b).clamp(0, n - 1)
        img = data.index_select(0, b)                              # (R,H,W,C)
        x1, y1, x2, y2 = (torch.round(rois[:, i] * self.spatial_scale)
                          for i in range(1, 5))
        # divided by tensors: CUDA divides by a host scalar as a product
        # with its reciprocal, which can move a bin's edge across an integer
        rw = (x2 - x1 + 1.0).clamp_min(1.0)
        rh = (y2 - y1 + 1.0).clamp_min(1.0)
        bin_w = rw / torch.full_like(rw, self.pooled_w)
        bin_h = rh / torch.full_like(rh, self.pooled_h)
        ys = torch.arange(h, dtype=torch.float32, device=data.device)
        xs = torch.arange(w, dtype=torch.float32, device=data.device)
        neg = torch.tensor(float("-inf"), dtype=data.dtype,
                           device=data.device)

        def span(p, size, lo, coords, limit):
            start = torch.floor(p * size) + lo
            end = torch.ceil((p + 1) * size) + lo
            return ((coords >= start[:, None]) & (coords < end[:, None])
                    & (coords >= 0) & (coords < limit))          # (R, size)

        cols, x_empty = [], []
        for px in range(self.pooled_w):
            xm = span(px, bin_w, x1, xs, w)                         # (R, W)
            cols.append(torch.where(xm[:, None, :, None], img, neg)
                        .amax(dim=2))                               # (R,H,C)
            x_empty.append(~xm.any(dim=1))
        cols = torch.stack(cols, dim=1)                             # (R,PW,H,C)
        x_empty = torch.stack(x_empty, dim=1)                       # (R, PW)
        rows = []
        for py in range(self.pooled_h):
            ym = span(py, bin_h, y1, ys, h)                         # (R, H)
            m = torch.where(ym[:, None, :, None], cols, neg).amax(dim=2)
            empty = (~ym.any(dim=1))[:, None] | x_empty
            rows.append(torch.where(empty[..., None], 0.0, m))      # (R,PW,C)
        return torch.stack(rows, dim=1)
