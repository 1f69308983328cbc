"""Weight interop (counterpart of ``bigdl_tpu/interop/state_dict.py``):
torch-convention state dicts for the causal LM, and the reference's module
trees for every other model (below ``flatten_tree``).

This is how weights cross between the two packages: the reference's
``export_lm_state_dict`` writes a ``{name: f32 numpy array}`` dict in the
standard torch names below, and ``import_lm_state_dict`` loads it into a
port model built with the same ``build_lm`` arguments. Layouts already
match (Linear (out, in), the stacked q;k;v in_proj), so it is a name
mapping with shape checks and no transposes. Token ids stay 1-based: id k
reads row k-1 of ``embedding.weight`` on both sides.

    embedding.weight                                 (V, E)
    pos_embedding.weight                             (max_len, E), learned
                                                     positions only
    encoder.layers.{i}.self_attn.in_proj_weight      (E + 2*E_kv, E)
    encoder.layers.{i}.self_attn.in_proj_bias        when bias or qkv_bias
    encoder.layers.{i}.self_attn.out_proj.weight     (E, E)
    encoder.layers.{i}.self_attn.out_proj.bias       when bias
    encoder.layers.{i}.linear1 / linear_gate / linear2 .{weight,bias}
    encoder.layers.{i}.norm1 / norm2 .{weight[,bias]} bias for LayerNorm only
    encoder.norm.{weight[,bias]}                     final norm (absent in
                                                     a post-norm stack)
    lm_head.{weight,bias}                            absent when tied; the
                                                     fused LMHead and the
                                                     unfused tail's Linear
                                                     share these keys
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.attention import (LearnedPositionalEncoding,
                                          TransformerEncoder)
from bigdl_tpu_torch.nn.linear import LMHead, Linear, LookupTable, TiedLMHead
from bigdl_tpu_torch.nn.recurrent import TimeDistributed


def _lm_parts(model: torch.nn.Module):
    """(embedding, encoder, head) of a build_lm-shaped model."""
    lookups = [m for m in model.modules() if isinstance(m, LookupTable)]
    encoders = [m for m in model.modules()
                if isinstance(m, TransformerEncoder)]
    heads = [m for m in model.modules() if isinstance(m, (LMHead, TiedLMHead))]
    if not heads:
        # the unfused tail: TimeDistributed(Linear) + LogSoftMax, whose
        # Linear carries the same lm_head.* keys
        heads = [td.inner for td in model.modules()
                 if isinstance(td, TimeDistributed)
                 and isinstance(td.inner, Linear)]
    if not (len(lookups) == 1 and len(encoders) == 1 and len(heads) == 1):
        raise ValueError(
            "expected a build_lm-shaped model (one LookupTable, one "
            f"TransformerEncoder, one LM head); found {len(lookups)}/"
            f"{len(encoders)}/{len(heads)}")
    return lookups[0], encoders[0], heads[0]


def _named_params(model) -> List[Tuple[str, torch.nn.Module, str]]:
    """[(torch_name, module, parameter name)] in a fixed order."""
    emb, enc, head = _lm_parts(model)
    out = [("embedding.weight", emb, "weight")]
    # GPT-2's learned table; the sinusoidal encoding is a constant
    wpes = [m for m in model.modules()
            if isinstance(m, LearnedPositionalEncoding)]
    if wpes:
        out.append(("pos_embedding.weight", wpes[0], "weight"))
    for i in range(enc.num_layers):
        layer = enc._modules[f"layer{i}"]
        if layer.moe_experts:
            raise ValueError("MoE layers have no torch-convention mapping")
        p = f"encoder.layers.{i}"
        attn = layer.self_attn
        out.append((f"{p}.self_attn.in_proj_weight", attn, "in_proj_weight"))
        if attn.with_bias or attn.qkv_bias:
            out.append((f"{p}.self_attn.in_proj_bias", attn, "in_proj_bias"))
        out.append((f"{p}.self_attn.out_proj.weight", attn, "out_proj_weight"))
        if attn.with_bias:
            out.append((f"{p}.self_attn.out_proj.bias", attn, "out_proj_bias"))
        for lin_name in ("linear1", "linear2", "linear_gate"):
            lin = layer._modules.get(lin_name)
            if lin is None:
                continue
            out.append((f"{p}.{lin_name}.weight", lin, "weight"))
            if lin.with_bias:
                out.append((f"{p}.{lin_name}.bias", lin, "bias"))
        for norm_name in ("norm1", "norm2"):
            norm = layer._modules[norm_name]
            out.append((f"{p}.{norm_name}.weight", norm, "weight"))
            if "bias" in norm._parameters:
                out.append((f"{p}.{norm_name}.bias", norm, "bias"))
    if enc.final_norm is not None:
        out.append(("encoder.norm.weight", enc.final_norm, "weight"))
        if "bias" in enc.final_norm._parameters:
            out.append(("encoder.norm.bias", enc.final_norm, "bias"))
    if isinstance(head, TiedLMHead):
        return out  # the head is embedding.weight
    out.append(("lm_head.weight", head, "weight"))
    if head.with_bias:
        out.append(("lm_head.bias", head, "bias"))
    return out


def export_lm_state_dict(model) -> Dict[str, np.ndarray]:
    """Torch-convention ``{name: f32 numpy array}`` of a build_lm model."""
    return {name: mod._parameters[pname].detach().float().cpu().numpy()
            for name, mod, pname in _named_params(model)}


def import_lm_state_dict(model, state_dict: Dict[str, Any],
                         strict: bool = True):
    """Load torch-convention weights into a build_lm model in place.

    Takes numpy arrays or anything ``np.asarray`` handles. A missing key is
    always rejected; ``strict=True`` (torch's semantics) rejects unexpected
    keys too, ``strict=False`` ignores them (the ``lm_head.weight`` that a
    tied checkpoint may carry). Every shape is checked before anything is
    written, so a rejected dict leaves the model as it was. Values are
    copied into the existing parameters, on their device and in their
    dtype."""
    entries = _named_params(model)
    missing = [n for n, _, _ in entries if n not in state_dict]
    if missing:
        raise KeyError(f"state_dict is missing {missing[:4]}"
                       f"{'...' if len(missing) > 4 else ''}")
    extra = sorted(set(state_dict) - {n for n, _, _ in entries})
    if strict and extra:
        raise KeyError(f"unexpected keys {extra[:4]}"
                       f"{'...' if len(extra) > 4 else ''} "
                       "(strict=False to ignore)")
    staged = []
    for name, mod, pname in entries:
        val = np.array(state_dict[name], np.float32)  # an owned copy
        param = mod._parameters[pname]
        if tuple(val.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {val.shape} != expected "
                             f"{tuple(param.shape)}")
        staged.append((param, val))
    with torch.no_grad():
        for param, val in staged:
            param.copy_(torch.from_numpy(val))
    return model


# ------------------------------------------------- module trees (the ResNet slice)
def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested ``{name: subtree or array}`` dict, such as the reference's
    ``parameter_tree()`` or ``buffer_tree()``, as ``{dotted name: f32
    numpy array}``."""
    out: Dict[str, np.ndarray] = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict):
            out.update(flatten_tree(value, key + "."))
        else:
            out[key] = np.asarray(value, np.float32)
    return out


def export_tree_state(model: torch.nn.Module
                      ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``(params, buffers)`` of a model as ``{dotted name: f32 numpy
    array}`` dicts. The names and layouts are the reference's
    ``parameter_tree()`` and ``buffer_tree()`` flattened with dots
    (children ``"0"``, ``"1"``, ..., conv weights HWIO; ``CAdd.bias``,
    ``Mul``/``CMul.weight``, a recurrent cell's ``w_ih``/``w_hh``/bias
    under ``<Recurrent>.cell``, ``BiRecurrent``'s under ``fwd``/``bwd``).
    A model sharded over a tensor axis
    (``parallel.tensor_parallel.shard_parameters``) or an expert axis
    (``parallel.expert.shard_experts``) exports its full leaves,
    reassembled over the axis: every rank of it must call."""
    def numpy(t):
        return t.detach().float().cpu().numpy()
    params = {n: p.detach() for n, p in model.named_parameters()}
    if getattr(model, "_tp_mesh", None) is not None:
        from bigdl_tpu_torch.parallel.tensor_parallel import gather_full
        params = gather_full(model, params)
    if getattr(model, "_ep_mesh", None) is not None:
        from bigdl_tpu_torch.parallel.expert import gather_experts
        params = gather_experts(model, params)
    return ({n: numpy(p) for n, p in params.items()},
            {n: numpy(b) for n, b in model.named_buffers()})


def _check_names(kind: str, want: Dict[str, torch.Tensor],
                 got: Dict[str, Any]) -> None:
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"{kind}: missing {missing[:4]}"
                       f"{'...' if len(missing) > 4 else ''}, unexpected "
                       f"{extra[:4]}{'...' if len(extra) > 4 else ''}")


def import_tree_state(model: torch.nn.Module, params: Dict[str, Any],
                      buffers: Dict[str, Any]) -> torch.nn.Module:
    """Load ``{dotted name: array}`` parameters and buffers (the shape of
    ``export_tree_state``'s, or the reference's trees through
    ``flatten_tree``) into ``model`` in place. Every name must be present
    and no other; every shape is checked before anything is written, so a
    rejected state leaves the model as it was. Values are copied into the
    existing tensors, on their device and in their dtype. Into a model
    sharded over a tensor or an expert axis, the full arrays are cut to
    this rank's slices (``tensor_parallel.local_slices``,
    ``expert.local_experts``) first."""
    if getattr(model, "_tp_mesh", None) is not None:
        from bigdl_tpu_torch.parallel.tensor_parallel import local_slices
        params = local_slices(model, {n: np.asarray(v, np.float32)
                                      for n, v in params.items()})
    if getattr(model, "_ep_mesh", None) is not None:
        from bigdl_tpu_torch.parallel.expert import local_experts
        params = local_experts(model, {n: np.asarray(v, np.float32)
                                       for n, v in params.items()})
    staged = []
    for kind, want, got in (("params", dict(model.named_parameters()), params),
                            ("buffers", dict(model.named_buffers()), buffers)):
        _check_names(kind, want, got)
        for name, t in want.items():
            val = np.array(got[name], np.float32)  # an owned copy
            if tuple(val.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {val.shape} != expected "
                                 f"{tuple(t.shape)}")
            staged.append((t, val))
    with torch.no_grad():
        for t, val in staged:
            t.copy_(torch.from_numpy(val))
    return model
