"""Training batch norm with a hand-written backward (counterpart of
``bigdl_tpu/ops/batch_norm.py``).

``batch_norm_train(x, gamma, beta, eps) -> (out, mean, var)`` normalises x
over every axis but the last with the batch statistics. The reference's
rules are kept: the statistics are f32 (f64 for f64 input, which the
reference never sees), from one pass of sum and sum of squares; ``var = max(E[x^2] - E[x]^2, 0)``, biased; the output is in x's
dtype; the backward is the closed form
``dx = gamma * inv / n * (n * dy - sum(dy) - xhat * sum(dy * xhat))``;
``mean`` and ``var`` feed the running statistics and are not
differentiated. The same forward-from-sums and backward serve the fused
conv+BN ops (``ops/conv_bn.py``, ``ops/conv3x3_bn.py``).
"""

from __future__ import annotations

import torch


def bn_from_stats(y: torch.Tensor, s: torch.Tensor, sq: torch.Tensor,
                  gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                  out_dtype: torch.dtype):
    """Train-mode BN of y from its sum ``s`` and sum of squares ``sq`` over
    all axes but the last, computed in the sums' dtype (f32, or f64 for f64
    input): ``(out, mean, var, inv)``, with xhat taken from y as given (the
    fused ops pass the rounded y)."""
    n = y.numel() // y.shape[-1]
    mean = s / n
    var = torch.clamp(sq / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    acc = s.dtype
    xhat = (y.to(acc) - mean) * inv
    out = (xhat * gamma.to(acc) + beta.to(acc)).to(out_dtype)
    return out, mean, var, inv


def bn_input_grad(dout: torch.Tensor, y: torch.Tensor, mean: torch.Tensor,
                  inv: torch.Tensor, gamma: torch.Tensor):
    """The closed-form BN backward in the statistics' dtype (f32, or f64
    for f64 input): ``(dy_in, dgamma, dbeta)`` for the BN input y."""
    axes = tuple(range(y.dim() - 1))
    n = y.numel() // y.shape[-1]
    acc = mean.dtype
    dy = dout.to(acc)
    xhat = (y.to(acc) - mean) * inv
    dbeta = dy.sum(axes)
    dgamma = (dy * xhat).sum(axes)
    g = gamma.to(acc)
    return (g * inv / n) * (n * dy - dbeta - xhat * dgamma), dgamma, dbeta


class BatchNormTrain(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``batch_norm_train``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        xa = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.dim() - 1))
        # sum(x) and sum(x*x) are independent: one pass over x
        s, sq = xa.sum(axes), (xa * xa).sum(axes)
        out, mean, var, inv = bn_from_stats(x, s, sq, gamma, beta, eps,
                                            x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        dx, dgamma, dbeta = bn_input_grad(dout, x, mean, inv, gamma)
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float):
    """``(out, mean, var)``: see the module docstring."""
    return BatchNormTrain.apply(x, gamma, beta, eps)
