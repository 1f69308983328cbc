"""Fused 1x1 conv + train-mode batch norm (counterpart of
``bigdl_tpu/ops/conv_bn.py``).

``conv1x1_bn_train(x2d, w, gamma, beta, eps) -> (out, mean, var)`` is the
reference's ``custom_vjp`` as a ``torch.autograd.Function``: x2d (M, K) @
w (K, N) through ``matmul_with_stats`` (kernel K5 on the card), then BN
over M with the batch statistics. As in the reference, the saved y is the
one rounded to x's dtype, the statistics come from the f32 product before
that rounding, and xhat is recomputed from the rounded y in the backward.
The backward is the closed-form BN gradient in f32, then ``dyconv @ w.T``
and ``x2d.T @ dyconv`` (plain matmuls, as in the reference). ``mean`` and
``var`` (biased) feed the running statistics and are not differentiated.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops.batch_norm import bn_from_stats, bn_input_grad
from bigdl_tpu_torch.ops.matmul_bn import matmul_with_stats


class Conv1x1BNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2d, w, gamma, beta, eps):
        y, s, sq = matmul_with_stats(x2d, w)
        out, mean, var, inv = bn_from_stats(y, s, sq, gamma, beta, eps,
                                            x2d.dtype)
        ctx.save_for_backward(x2d, w, gamma, y, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x2d, w, gamma, y, mean, inv = ctx.saved_tensors
        dyconv, dgamma, dbeta = bn_input_grad(dout, y, mean, inv, gamma)
        dt = torch.promote_types(x2d.dtype, w.dtype)
        dyconv = dyconv.to(x2d.dtype).to(dt)
        dx = dyconv @ w.to(dt).T
        dw = x2d.to(dt).T @ dyconv
        return (dx.to(x2d.dtype), dw.to(w.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


def conv1x1_bn_train(x2d: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float):
    """``(out, mean, var)``: see the module docstring."""
    return Conv1x1BNTrain.apply(x2d, w, gamma, beta, eps)
