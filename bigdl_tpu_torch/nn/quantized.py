"""Int8 weight-only and bf16 inference twins (counterpart of
``bigdl_tpu/nn/quantized.py``).

``quantize_model`` deep-copies a model and swaps every ``Linear``,
``LMHead``, ``TiedLMHead``, ``SpatialConvolution``, ``MultiHeadAttention``
and ``LookupTable`` for its quantized twin: symmetric per-output-channel
int8 weights (``q = round(w / s)``, ``s = amax|w| / 127``) held as buffers
beside their f32 scales. Decode-shaped projections run kernel K4 on the
int8 rows (``ops/int8_matmul.py``); the convolution twin dequantizes its
HWIO kernel in the compute dtype and convolves, as the reference does.
Every remaining parameter is frozen into a buffer, so the twin is
inference-only. ``cast_model`` is the bf16 sibling: every float parameter
becomes a buffer of the given dtype.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.linear import Linear, LMHead, LookupTable, TiedLMHead
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.int8_matmul import int8_matmul
from bigdl_tpu_torch.utils.device import DeviceLike, check_module_device


def quantize_array(w: torch.Tensor, channel_axis: int):
    """Symmetric int8 per-channel quantization -> ``(q int8, scale f32)``;
    the scale keeps w's rank with size 1 off ``channel_axis``. Rounds half
    to even, as the reference does."""
    w = w.detach().float()
    axes = tuple(a for a in range(w.dim()) if a != channel_axis % w.dim())
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _freeze(m: torch.nn.Module, dtype=None) -> None:
    """Move a module's own parameters into buffers (optionally cast); their
    regularizers go with them."""
    m.__dict__.pop("_param_regularizers", None)
    for name in list(m._parameters):
        t = m._parameters.pop(name).detach()
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        m.register_buffer(name, t)


class _QuantizedMixin:
    """Shared plumbing: named weights become int8 buffers + f32 scales."""

    compute_dtype = torch.bfloat16
    #: weight name -> its output-channel axis
    _quant_weights: Dict[str, int] = {}

    @classmethod
    def _validate(cls, m: Module) -> None:
        """Runs before the swap, so a rejected module is left as it was."""

    def _dequant(self, name: str) -> torch.Tensor:
        cd = self.compute_dtype
        return (self._buffers[name + "_q"].to(cd)
                * self._buffers[name + "_scale"].to(cd))

    def reset(self):
        raise RuntimeError(f"{type(self).__name__} is inference-only")

    def _quantize_in_place(self, compute_dtype: torch.dtype) -> None:
        self.compute_dtype = compute_dtype
        for name, axis in self._quant_weights.items():
            q, scale = quantize_array(self._parameters.pop(name), axis)
            self.register_buffer(name + "_q", q)
            self.register_buffer(name + "_scale", scale)
        _freeze(self)

    def _bias(self):
        return self._buffers["bias"] if self.with_bias else None

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                f"{type(self).__name__} is an inference-only twin; call "
                "evaluate_mode()")


class QuantizedLinear(_QuantizedMixin, Linear):
    """Linear with an int8 weight and per-row scale (inference-only)."""

    _quant_weights = {"weight": 0}  # (out, in)

    weight = property(lambda self: self._dequant("weight"))

    def forward(self, input):
        return int8_matmul(input, self.weight_q, self.weight_scale,
                           bias=self._bias(), compute_dtype=self.compute_dtype)


class QuantizedLMHead(_QuantizedMixin, LMHead):
    """LMHead with an int8 vocab projection; eval log-probs only."""

    _quant_weights = {"weight": 0}  # (V, E)

    weight = property(lambda self: self._dequant("weight"))

    def forward(self, input):
        self._check_eval()
        y = int8_matmul(self._last(input), self.weight_q, self.weight_scale,
                        bias=self._bias(), compute_dtype=self.compute_dtype)
        return torch.log_softmax(y, dim=-1)


class QuantizedSpatialConvolution(_QuantizedMixin, SpatialConvolution):
    """SpatialConvolution with an int8 HWIO kernel and a per-output-channel
    f32 scale (reference ``QuantizedSpatialConvolution``; inference-only).
    The kernel is dequantized in the compute dtype at every forward, the
    input is cast to it, and the f32 bias is added after the conv."""

    _quant_weights = {"weight": -1}  # HWIO: the output channel is last

    weight = property(lambda self: self._dequant("weight"))


class QuantizedMultiHeadAttention(_QuantizedMixin, MultiHeadAttention):
    """MultiHeadAttention with int8 q;k;v and out projections. The q, k and
    v projections run the int8 matmul on row slices of the stacked weight
    (per-row scales slice with the rows), so the full matrix is never
    dequantized; attention and the KV cache are inherited."""

    _quant_weights = {"in_proj_weight": 0, "out_proj_weight": 0}

    in_proj_weight = property(lambda self: self._dequant("in_proj_weight"))
    out_proj_weight = property(lambda self: self._dequant("out_proj_weight"))

    def _cache_dtype(self) -> torch.dtype:
        return self.compute_dtype

    def _in_projections(self, x, key=None, value=None):
        key = x if key is None else key
        value = x if value is None else value
        e, ekv = self.embed_dim, self._e_kv
        wq, sq = self.in_proj_weight_q, self.in_proj_weight_scale
        cd = self.compute_dtype
        # under qkv_bias (Qwen2) the q/k/v rows carry a bias without with_bias
        bq, bk, bv = self._in_bias()
        return (int8_matmul(x, wq[:e], sq[:e], bq, cd),
                int8_matmul(key, wq[e:e + ekv], sq[e:e + ekv], bk, cd),
                int8_matmul(value, wq[e + ekv:], sq[e + ekv:], bv, cd))

    def _out_projection(self, ctx):
        out = int8_matmul(ctx, self.out_proj_weight_q,
                          self.out_proj_weight_scale,
                          compute_dtype=self.compute_dtype)
        if self.with_bias:
            out = out + self.out_proj_bias.to(self.compute_dtype)
        return out


class QuantizedLookupTable(_QuantizedMixin, LookupTable):
    """Embedding that gathers int8 rows and dequantizes only those."""

    _quant_weights = {"weight": 0}  # (vocab, dim): per-row scale

    weight = property(lambda self: self._dequant("weight"))

    @classmethod
    def _validate(cls, m):
        if m.max_norm != float("inf"):
            raise ValueError("max-norm LookupTable cannot be quantized "
                             "(renormalisation needs the f32 table)")

    def forward(self, input):
        idx = self._ids(input)
        cd = self.compute_dtype
        rows = self.weight_q[idx].to(cd)
        return self._pad(input,
                         rows * self.weight_scale[:, 0][idx][..., None].to(cd))


class QuantizedTiedLMHead(_QuantizedMixin, TiedLMHead):
    """TiedLMHead over the quantized embedding (``quantize_model`` swaps
    both): the vocab projection runs the int8 matmul on the table's int8
    rows."""

    _quant_weights = {}  # the tied table lives in the LookupTable

    def forward(self, input):
        embed = self.embed_ref
        self._check_eval()
        y = int8_matmul(self._last(input), embed.weight_q, embed.weight_scale,
                        compute_dtype=self.compute_dtype)
        return torch.log_softmax(y, dim=-1)


_REGISTRY = {
    Linear: QuantizedLinear,
    LMHead: QuantizedLMHead,
    SpatialConvolution: QuantizedSpatialConvolution,
    MultiHeadAttention: QuantizedMultiHeadAttention,
    LookupTable: QuantizedLookupTable,
    TiedLMHead: QuantizedTiedLMHead,
}


def quantize_module(m: Module, compute_dtype=torch.bfloat16) -> Module:
    """In-place class swap and weight quantization of one supported module."""
    qcls = _REGISTRY.get(type(m))
    if qcls is None:
        raise ValueError(f"no quantized twin for {type(m).__name__}")
    qcls._validate(m)
    m.__class__ = qcls
    m._quantize_in_place(compute_dtype)
    return m


def quantize_model(model: Module, compute_dtype=torch.bfloat16, *,
                   device: DeviceLike = "cuda") -> Module:
    """Deep-copied, int8 weight-only, inference-only twin of ``model``, in
    eval mode; ``model`` (which must live on ``device``) is untouched.
    Exact instances of the registry classes are swapped; subclasses are left
    alone."""
    check_module_device(model, device)
    qmodel = copy.deepcopy(model)
    for m in list(qmodel.modules()):
        if type(m) in _REGISTRY:
            quantize_module(m, compute_dtype)
    for m in qmodel.modules():
        _freeze(m)
    return qmodel.evaluate_mode()


def cast_model(model: Module, dtype=torch.bfloat16, *,
               device: DeviceLike = "cuda") -> Module:
    """Deep-copied inference twin with every float parameter cast to
    ``dtype`` and frozen into a buffer (buffers such as positional tables
    keep their dtype and cast at use)."""
    check_module_device(model, device)
    twin = copy.deepcopy(model)
    for m in twin.modules():
        _freeze(m, dtype)
    return twin.evaluate_mode()
