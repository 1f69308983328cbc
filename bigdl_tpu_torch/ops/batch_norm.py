"""Training batch norm with a hand-written backward (counterpart of
``bigdl_tpu/ops/batch_norm.py``).

``batch_norm_train(x, gamma, beta, eps) -> (out, mean, var)`` normalises x
over every axis but the last with the batch statistics. The reference's
rules are kept but one: the statistics are f32 (f64 for f64 input, which
the reference never sees), biased; the output is in x's dtype. The
reference takes ``var = max(E[x^2] - E[x]^2, 0)`` from one pass of sum and
sum of squares; here the op takes ``torch.var_mean`` (Welford's update),
because in f32 the difference of the two means loses the variance of a
channel whose values lie close together (ROADMAP C.6). The fused ops
still form their statistics from their kernels' sums (``bn_from_stats``);
the backward is the closed form
``dx = gamma * inv / n * (n * dy - sum(dy) - xhat * sum(dy * xhat))``;
``mean`` and ``var`` feed the running statistics and are not
differentiated. The same forward-from-sums and backward serve the fused
conv+BN ops (``ops/conv_bn.py``, ``ops/conv3x3_bn.py``).

Synchronized batch norm: inside ``synchronized(mesh)`` (a data-parallel
``parallel.mesh.Mesh`` of more than one rank; ``DistriOptimizer`` enters it
in its ``allreduce`` and ``fsdp`` steps) the statistics are those of the
GLOBAL batch, as XLA computes the reference's over a sharded batch: the
fused ops all-reduce their per-channel sums and sums of squares, the
Welford moments merge by counts across ranks (an all-gather of each rank's
count, mean and M2), and the backward all-reduces ``sum(dy)`` and
``sum(dy * xhat)`` and divides by the global count, so each rank's input
gradient is that of the global loss. The ``dgamma`` and ``dbeta`` it
returns stay this rank's, which the gradient all-reduce then sums. Every
rank must hold the same number of rows.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from bigdl_tpu_torch.ops import remat

_sync_mesh = None


@contextlib.contextmanager
def synchronized(mesh):
    """Batch statistics over every rank of ``mesh`` inside the block (a
    mesh of one, or None, keeps them this rank's)."""
    global _sync_mesh
    prev = _sync_mesh
    _sync_mesh = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _sync_mesh = prev


def sync_mesh():
    """The mesh batch statistics are synchronized over, or None."""
    return _sync_mesh


def merge_moments(mean: torch.Tensor, var: torch.Tensor, n: int, mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global (mean, biased var) from each rank's, merged by counts
    (Chan's parallel form of Welford's update) in rank order."""
    c = mean.shape[0]
    mine = torch.cat([mean, var * n, mean.new_tensor([float(n)])])
    every = mesh.all_gather(mine).view(mesh.size, 2 * c + 1)
    counts = every[:, 2 * c:]
    means, m2s = every[:, :c], every[:, c:2 * c]
    total = counts.sum()
    gmean = (counts * means).sum(0) / total
    m2 = m2s.sum(0) + (counts * (means - gmean) ** 2).sum(0)
    return gmean, m2 / total


def _batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xa = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(xa, dim=tuple(range(x.dim() - 1)),
                               correction=0)
    return mean, var


#: mean and biased variance over every axis but the last (Welford's
#: update), in f32 (f64 for f64 input); tagged "bn_stats" for
#: ``set_remat("conv")``
batch_moments = remat.tagged_op("bigdl_tpu_torch::batch_moments",
                                "bn_stats", _batch_moments)


def bn_from_moments(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                    out_dtype: torch.dtype):
    """Train-mode BN of y from its ``mean`` and ``var`` over all axes but
    the last, computed in their dtype: ``(out, mean, var, inv)``."""
    inv = torch.rsqrt(var + eps)
    acc = mean.dtype
    xhat = (y.to(acc) - mean) * inv
    out = (xhat * gamma.to(acc) + beta.to(acc)).to(out_dtype)
    return out, mean, var, inv


def bn_from_stats(y: torch.Tensor, s: torch.Tensor, sq: torch.Tensor,
                  gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                  out_dtype: torch.dtype, mesh=None):
    """Train-mode BN of y from its sum ``s`` and sum of squares ``sq`` over
    all axes but the last, computed in the sums' dtype (f32, or f64 for f64
    input): ``(out, mean, var, inv)``, with xhat taken from y as given (the
    fused ops pass the rounded y). With ``mesh`` the sums are all-reduced
    first: the global batch's statistics."""
    n = y.numel() // y.shape[-1]
    if mesh is not None:
        c = s.shape[0]
        both = mesh.all_reduce(torch.cat([s, sq]))
        s, sq, n = both[:c], both[c:], n * mesh.size
    mean = s / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    return bn_from_moments(y, mean, var, gamma, beta, eps, out_dtype)


def bn_input_grad(dout: torch.Tensor, y: torch.Tensor, mean: torch.Tensor,
                  inv: torch.Tensor, gamma: torch.Tensor, mesh=None):
    """The closed-form BN backward in the statistics' dtype (f32, or f64
    for f64 input): ``(dy_in, dgamma, dbeta)`` for the BN input y. With
    ``mesh`` (statistics of the global batch) dy_in takes the global sums
    and count; dgamma and dbeta stay this rank's."""
    axes = tuple(range(y.dim() - 1))
    n = y.numel() // y.shape[-1]
    acc = mean.dtype
    dy = dout.to(acc)
    xhat = (y.to(acc) - mean) * inv
    dbeta = dy.sum(axes)
    dgamma = (dy * xhat).sum(axes)
    g = gamma.to(acc)
    if mesh is None:
        return (g * inv / n) * (n * dy - dbeta - xhat * dgamma), dgamma, dbeta
    c = dbeta.shape[0]
    both = mesh.all_reduce(torch.cat([dbeta, dgamma]))
    n = n * mesh.size
    dx = (g * inv / n) * (n * dy - both[:c] - xhat * both[c:])
    return dx, dgamma, dbeta


class BatchNormTrain(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``batch_norm_train``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        mean, var = batch_moments(x)
        ctx.mesh = mesh = sync_mesh()
        if mesh is not None:
            mean, var = merge_moments(mean, var, x.numel() // x.shape[-1],
                                      mesh)
        out, mean, var, inv = bn_from_moments(x, mean, var, gamma, beta,
                                              eps, x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        dx, dgamma, dbeta = bn_input_grad(dout, x, mean, inv, gamma,
                                          ctx.mesh)
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float):
    """``(out, mean, var)``: see the module docstring."""
    return BatchNormTrain.apply(x, gamma, beta, eps)
