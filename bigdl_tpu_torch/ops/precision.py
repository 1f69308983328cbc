"""Mixed-precision helpers (counterpart of ``bigdl_tpu/ops/precision.py``:
``match_compute``, ``DtypePolicy`` and ``cast_tree`` are ported), and
``split_tf32``, the f32 split of the 3xTF32 kernel variants in plain
PyTorch (for their checks; no path of the port calls it).

Policy: the master parameters stay f32 and the optimizer updates them;
under ``DtypePolicy.bf16()`` the training forward and backward run on bf16
copies of them (``cast_params_for_compute``, handed to
``torch.func.functional_call``), and autograd brings the gradients back
through the casts to the f32 masters.
"""

from __future__ import annotations

from typing import Dict

import torch


def match_compute(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cast activation ``x`` to the weight's dtype when the weight's float
    type is narrower, so the matmul runs in the weight's precision; no-op in
    uniform precision and for integer inputs."""
    if (x.dtype != w.dtype and x.is_floating_point() and w.is_floating_point()
            and torch.finfo(w.dtype).bits < torch.finfo(x.dtype).bits):
        return x.to(w.dtype)
    return x


class DtypePolicy:
    """Compute and parameter dtypes of a training run."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype

    @staticmethod
    def fp32() -> "DtypePolicy":
        return DtypePolicy()

    @staticmethod
    def bf16() -> "DtypePolicy":
        """bf16 compute over f32 master parameters."""
        return DtypePolicy(compute_dtype=torch.bfloat16)

    @property
    def is_mixed(self) -> bool:
        return self.compute_dtype != self.param_dtype

    def cast_params_for_compute(self, params: Dict[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
        """Compute-dtype copies of the float parameters, still linked to
        them by autograd. Inputs are never cast here: layers cast their
        activations at the matmul (``match_compute``), so token ids stay
        exact (bf16 has 8 mantissa bits)."""
        if not self.is_mixed:
            return dict(params)
        return {name: p.to(self.compute_dtype) if p.is_floating_point() else p
                for name, p in params.items()}


def cast_tree(tree, dtype):
    """Every floating tensor leaf of a nested dict, list or tuple cast to
    ``dtype``; any other leaf kept (reference ``cast_tree``)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


#: low f32 mantissa bits that tf32 drops (it keeps 10 of the 23)
_TF32_DROPPED_BITS = 13


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does; kept as f32."""
    bits = x.float().contiguous().view(torch.int32)
    half = 1 << (_TF32_DROPPED_BITS - 1)
    # sign and magnitude: adding half an ulp to the magnitude's bits and
    # clearing the dropped ones rounds the magnitude, ties away from zero
    keep = ~((1 << _TF32_DROPPED_BITS) - 1)
    return ((bits + half) & keep).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)``: ``hi = tf32(x)``, ``lo = tf32(x - hi)``, both f32, as
    the kernels' "tf32x3" variants split each operand (``x - hi`` is exact
    in f32; ``hi + lo`` is x to about 2^-22 of it). A product of two
    splits to f32 accuracy is ``hi_a hi_b + hi_a lo_b + lo_a hi_b``."""
    hi = to_tf32(x)
    return hi, to_tf32(x.float() - hi)
