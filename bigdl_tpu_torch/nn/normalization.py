"""Normalization layers (counterpart of ``bigdl_tpu/nn/normalization.py``;
every class is ported).

Layout is channels-last: the channel is the last dim. Running statistics
are f32 buffers. The reference threads them functionally through its
jitted step; here they are updated IN PLACE under ``torch.no_grad()``, so
the update lands on the module's own buffers whether the model is called
directly or through ``torch.func.functional_call`` with its parameters
only (as ``Optimizer`` does), and never enters the autograd graph.

The local (subtractive, divisive, contrastive) normalizations keep the
reference's kernel (a normalised 9x9 gaussian unless one is given), its
``kernel`` buffers and its edge correction: the local mean is divided by
the kernel's coverage of the image at each position (a convolution of
ones), so the border sees a mean over the pixels that exist.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.module import Module, TensorModule
from bigdl_tpu_torch.ops import remat
from bigdl_tpu_torch.ops.batch_norm import batch_norm_train, sync_mesh


@torch.no_grad()
def blend_running_stats(module: Module, mean: torch.Tensor, var: torch.Tensor,
                        n: int, momentum: float) -> None:
    """The running-stat update shared by ``BatchNormalization`` and the
    fused conv+BN modules: the unbiased ``n / (n - 1)`` correction of the
    batch variance, then the ``momentum`` blend into ``running_mean`` and
    ``running_var``, in place."""
    if remat.recomputing():
        return  # a recomputed forward (set_remat) moves nothing twice
    mesh = sync_mesh()
    if mesh is not None:   # the global batch's statistics and count
        n = n * mesh.size
    unbiased = var * (n / max(1, n - 1))
    rm, rv = module.running_mean, module.running_var
    rm.copy_((1 - momentum) * rm + momentum * mean)
    rv.copy_((1 - momentum) * rv + momentum * unbiased)


class BatchNormalization(TensorModule):
    """Batch norm over (N, C) inputs (reference ``BatchNormalization``):
    train mode normalises with the batch statistics
    (``ops.batch_norm.batch_norm_train``) and blends them into the running
    ones; eval mode uses the running ones. Inside ``synchronized(mesh)``
    the statistics and the count are the global batch's."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.weight = torch.nn.Parameter(init.ones((n_output,)))
            self.bias = torch.nn.Parameter(init.zeros((n_output,)))
        self.register_buffer("running_mean", init.zeros((n_output,)))
        self.register_buffer("running_var", init.ones((n_output,)))

    def forward(self, input):
        if self.training:
            if self.affine:
                gamma, beta = self.weight, self.bias
            else:
                gamma = torch.ones(self.n_output, dtype=input.dtype,
                                   device=input.device)
                beta = torch.zeros_like(gamma)
            out, mean, var = batch_norm_train(input, gamma, beta, self.eps)
            blend_running_stats(self, mean, var,
                                input.numel() // input.shape[-1],
                                self.momentum)
            return out
        out = (input - self.running_mean) * torch.rsqrt(self.running_var
                                                        + self.eps)
        if self.affine:
            out = out * self.weight + self.bias
        return out


class SpatialBatchNormalization(BatchNormalization):
    """Batch norm over (N, H, W, C): the same math, channel = last dim
    (reference ``SpatialBatchNormalization``)."""


class VolumetricBatchNormalization(BatchNormalization):
    """Batch norm over (N, D, H, W, C) (reference
    ``VolumetricBatchNormalization``)."""


class SpatialCrossMapLRN(TensorModule):
    """AlexNet-style local response normalization across channels
    (reference ``SpatialCrossMapLRN``): ``x * (k + alpha / size * S)^-beta``
    where S is the sum of squares over a window of ``size`` channels,
    zero-padded by ``size // 2`` before and ``size - size // 2 - 1`` after.
    Channel is the last dim. Everything is computed in the input's dtype,
    the window's squares added one channel offset after another, as the
    reference's ``reduce_window`` adds them. Not a TPU kernel: plain
    PyTorch on either device."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0):
        super().__init__()
        self.size = size
        self.alpha, self.beta, self.k = alpha, beta, k

    def forward(self, input):
        sq = input * input
        pre = self.size // 2
        post = self.size - pre - 1
        padded = torch.nn.functional.pad(sq, (pre, post))
        c = input.shape[-1]
        window = padded[..., 0:c]
        for j in range(1, self.size):
            window = window + padded[..., j:j + c]
        scale = torch.pow(self.k + window * (self.alpha / self.size),
                          -self.beta)
        return input * scale


class InputNormalize(TensorModule):
    """Cast the input to ``dtype`` and normalise each channel (the last
    axis): ``(x - mean) / std`` computed as ``(x - mean) * (1 / std)``, as
    the reference does (reference ``InputNormalize``). No parameters; the
    mean and 1/std are plain attributes, as in the reference (so they are
    not buffers of the state dict), made on the input's device at first
    use."""

    def __init__(self, mean, std, dtype=torch.float32):
        super().__init__()
        self.mean = np.asarray(mean, np.float32)
        self.rstd = 1.0 / np.asarray(std, np.float32)
        self.dtype = dtype
        self._consts = {}

    def forward(self, input):
        key = (input.device, self.dtype)
        if key not in self._consts:
            self._consts[key] = tuple(
                torch.as_tensor(a).to(device=input.device, dtype=self.dtype)
                for a in (self.mean, self.rstd))
        mean, rstd = self._consts[key]
        return (input.to(self.dtype) - mean) * rstd


class Normalize(TensorModule):
    """Divide each sample by its Lp norm over the last axis, plus ``eps``
    (reference ``Normalize``); ``p = inf`` is the max norm."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10):
        super().__init__()
        self.p, self.eps = p, eps

    def forward(self, input):
        if np.isinf(self.p):
            norm = input.abs().amax(dim=-1, keepdim=True)
        else:
            norm = input.abs().pow(self.p).sum(dim=-1, keepdim=True) \
                .pow(1.0 / self.p)
        return input / (norm + self.eps)


def _gaussian2d(kernel_size: int) -> np.ndarray:
    """The default local-normalization kernel: a normalised 2-D gaussian
    of sigma ``kernel_size / 4``."""
    sigma = 0.25 * kernel_size
    ax = np.arange(kernel_size) - (kernel_size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


class SpatialSubtractiveNormalization(TensorModule):
    """Subtract the kernel-weighted local mean over every channel
    (reference ``SpatialSubtractiveNormalization``): channels-last (N,) H,
    W, C input; a 1-D kernel is its outer product with itself; the kernel
    is scaled to sum to 1 / n_input_plane."""

    def __init__(self, n_input_plane: int = 1, kernel=None):
        super().__init__()
        self.n_input_plane = n_input_plane
        k = (np.asarray(kernel, np.float32) if kernel is not None
             else _gaussian2d(9))
        if k.ndim == 1:
            k = np.outer(k, k)
        k = k / (k.sum() * n_input_plane)
        self.register_buffer("kernel", torch.from_numpy(k.astype(np.float32)))

    def _local_mean(self, input):
        n, h, w, c = input.shape
        kh, kw = self.kernel.shape
        pad = (kh // 2, kw // 2)
        k = self.kernel.to(input.dtype)
        smooth = F.conv2d(input.permute(0, 3, 1, 2),
                          k.expand(c, 1, kh, kw), padding=pad, groups=c)
        mean = smooth.sum(dim=1, keepdim=True)                  # (N,1,H',W')
        coef = F.conv2d(torch.ones((1, 1, h, w), dtype=input.dtype,
                                   device=input.device),
                        (k * self.n_input_plane)[None, None], padding=pad)
        return (mean / coef).permute(0, 2, 3, 1)

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        out = x - self._local_mean(x)
        return out[0] if squeeze else out


class SpatialDivisiveNormalization(TensorModule):
    """Divide by the local standard deviation, which a value under
    ``threshold`` replaces with ``thresval`` (reference
    ``SpatialDivisiveNormalization``; its kernel lives in child ``sub``)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.threshold, self.thresval = threshold, thresval

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        stdev = torch.sqrt(self.sub._local_mean(x * x).clamp_min(0.0))
        stdev = torch.where(stdev < self.threshold, self.thresval, stdev)
        out = x / stdev
        return out[0] if squeeze else out


class SpatialContrastiveNormalization(TensorModule):
    """Subtractive, then divisive normalization (reference
    ``SpatialContrastiveNormalization``; children ``sub_norm`` and
    ``div_norm``)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.sub_norm = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.div_norm = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                     threshold, thresval)

    def forward(self, input):
        return self.div_norm(self.sub_norm(input))
