"""HuggingFace-layout checkpoints of GPT-2- and Llama-family LMs (counterpart
of ``bigdl_tpu/interop/hf.py``): import, export, and the directory format.

Every importer is a name and layout map onto ``models.transformer.build_lm``:

- GPT-2 (``GPT2LMHeadModel``): HF keeps each projection as a ``Conv1D``
  with an (in, out) weight, the transpose of our ``Linear``'s (out, in),
  so ``c_attn``/``c_proj``/``c_fc`` transpose on the way in; ``c_attn``'s
  columns are already q;k;v-stacked. Learned ``wpe`` positions, tied head.
- Llama and Mistral (``LlamaForCausalLM``): ``q_proj``/``k_proj``/``v_proj``
  concatenate row-wise into our GQA ``in_proj_weight`` (E + 2 E_kv, E);
  ``gate_proj`` (inside silu) is our ``linear1``, ``up_proj`` our
  ``linear_gate``, ``down_proj`` our ``linear2``. The rotate-half RoPE
  pairing is the same, so q/k need no permutation. A ``sliding_window``
  (Mistral) becomes ``window``; ``rope_scaling`` of type ``llama3``,
  ``linear`` or ``yarn`` is carried, any other refused.
- Qwen2: the Llama block with q/k/v biases (``qkv_bias=True``).

Token ids stay 1-based on our side: the tables are copied verbatim, so our
id k is HF id k - 1 (``to_framework_ids`` / ``to_hf_ids``). The models
return log-probabilities, ``log_softmax`` of HF's logits.

The directory format is ``config.json`` beside ``*.safetensors`` (or
``pytorch_model*.bin``, read with ``torch.load(weights_only=True)``). The
safetensors files are read and written by this module's own code (an
8-byte little-endian header length, a JSON header, then the raw bytes):
F32, F16 and the integer types through numpy, BF16 (the dtype of real
Llama and Qwen2 checkpoints) through ``torch.frombuffer``; any other dtype
raises ``ValueError``. Export writes F32, as the reference does.

The loaders build the model skeleton on the ``meta`` device and give it the
checkpoint's values on ``device`` (default ``cuda``; ``"cpu"`` on request),
so no parameter is drawn at random only to be written over.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict

import numpy as np
import torch

from bigdl_tpu_torch.interop.state_dict import (_lm_parts, _named_params,
                                                export_lm_state_dict,
                                                import_lm_state_dict)
from bigdl_tpu_torch.nn.linear import TiedLMHead
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def to_framework_ids(ids):
    """HF 0-based token ids -> this framework's 1-based ids."""
    return np.asarray(ids) + 1


def to_hf_ids(ids):
    """This framework's 1-based token ids -> HF 0-based ids."""
    return np.asarray(ids) - 1


def _np(v) -> np.ndarray:
    """A state-dict value (torch tensor or array) as f32 numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _build_loaded(kwargs: Dict[str, Any], ours: Dict[str, np.ndarray],
                  strict: bool, device: DeviceLike):
    """A ``build_lm(**kwargs)`` model on ``device`` holding ``ours``. The
    module tree is made on the ``meta`` device (nothing drawn), given
    storage on ``device``, and loaded with the reference's ``strict``.
    Without ``strict`` a checkpoint may leave out the q/k/v biases, which
    then take the reference's initial value, zeros."""
    from bigdl_tpu_torch.models.transformer import lm_modules
    with torch.device("meta"):
        model = lm_modules(**kwargs)
    model = model.to_empty(device=resolve_device(device)).evaluate_mode()
    if not strict:
        ours = dict(ours)
        for name, mod, pname in _named_params(model):
            if name.endswith("in_proj_bias") and name not in ours:
                ours[name] = np.zeros(mod._parameters[pname].shape,
                                      np.float32)
    return import_lm_state_dict(model, ours, strict=strict)


# --------------------------------------------------------------------- GPT-2
def gpt2_lm_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    """``build_lm`` arguments for an HF GPT-2 ``config.json`` dict."""
    e = int(config["n_embd"])
    n_inner = config.get("n_inner") or 4 * e
    act = config.get("activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh", "gelu"):
        raise ValueError(f"unsupported GPT-2 activation {act!r}")
    # variants that change the attention's arithmetic are refused
    if config.get("scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx=True divides "
                         "attention scores per layer; not mapped")
    if not config.get("scale_attn_weights", True):
        raise ValueError("scale_attn_weights=False (unscaled attention) "
                         "is not mapped")
    # "gelu" is the exact erf form; gelu_new / gelu_pytorch_tanh the tanh one
    return dict(
        vocab_size=int(config["vocab_size"]),
        embed_dim=e,
        num_heads=int(config["n_head"]),
        ffn_dim=int(n_inner),
        num_layers=int(config["n_layer"]),
        max_len=int(config.get("n_positions", 1024)),
        pos="learned",
        tie_embeddings=True,
        activation="gelu_exact" if act == "gelu" else "gelu",
        norm="layer",
        norm_eps=float(config.get("layer_norm_epsilon", 1e-5)),
    )


def gpt2_state_dict_to_lm(hf_sd: Dict[str, Any],
                          num_layers: int) -> Dict[str, np.ndarray]:
    """HF GPT-2 state dict -> our torch-convention LM state dict.

    Takes ``GPT2LMHeadModel`` keys (``transformer.``-prefixed) or bare
    ``GPT2Model`` keys; ignores HF's non-weight buffers (``attn.bias``,
    ``attn.masked_bias``) and the tied ``lm_head.weight``."""
    sd = {(k[len("transformer."):] if k.startswith("transformer.") else k): v
          for k, v in hf_sd.items()}
    out: Dict[str, np.ndarray] = {
        "embedding.weight": _np(sd["wte.weight"]),
        "pos_embedding.weight": _np(sd["wpe.weight"]),
        "encoder.norm.weight": _np(sd["ln_f.weight"]),
        "encoder.norm.bias": _np(sd["ln_f.bias"]),
    }
    for i in range(num_layers):
        src, dst = f"h.{i}", f"encoder.layers.{i}"
        out[f"{dst}.norm1.weight"] = _np(sd[f"{src}.ln_1.weight"])
        out[f"{dst}.norm1.bias"] = _np(sd[f"{src}.ln_1.bias"])
        out[f"{dst}.norm2.weight"] = _np(sd[f"{src}.ln_2.weight"])
        out[f"{dst}.norm2.bias"] = _np(sd[f"{src}.ln_2.bias"])
        # Conv1D (in, out) -> Linear (out, in)
        out[f"{dst}.self_attn.in_proj_weight"] = \
            _np(sd[f"{src}.attn.c_attn.weight"]).T.copy()
        out[f"{dst}.self_attn.in_proj_bias"] = \
            _np(sd[f"{src}.attn.c_attn.bias"])
        out[f"{dst}.self_attn.out_proj.weight"] = \
            _np(sd[f"{src}.attn.c_proj.weight"]).T.copy()
        out[f"{dst}.self_attn.out_proj.bias"] = \
            _np(sd[f"{src}.attn.c_proj.bias"])
        out[f"{dst}.linear1.weight"] = _np(sd[f"{src}.mlp.c_fc.weight"]).T.copy()
        out[f"{dst}.linear1.bias"] = _np(sd[f"{src}.mlp.c_fc.bias"])
        out[f"{dst}.linear2.weight"] = \
            _np(sd[f"{src}.mlp.c_proj.weight"]).T.copy()
        out[f"{dst}.linear2.bias"] = _np(sd[f"{src}.mlp.c_proj.bias"])
    return out


def load_gpt2(config: Dict[str, Any], state_dict: Dict[str, Any], *,
              device: DeviceLike = "cuda"):
    """A ``build_lm`` model on ``device`` from an HF GPT-2 config and
    state dict."""
    resolve_device(device)  # no card: refuse before any work
    kwargs = gpt2_lm_kwargs(config)
    ours = gpt2_state_dict_to_lm(state_dict, kwargs["num_layers"])
    return _build_loaded(kwargs, ours, True, device)


# --------------------------------------------------------------------- Llama
def llama_lm_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    """``build_lm`` arguments for an HF Llama-family ``config.json`` dict
    (Mistral's too: its ``sliding_window`` becomes ``window``)."""
    if config.get("attention_bias", False) or config.get("mlp_bias", False):
        raise ValueError("biased Llama variants are not mapped (set "
                         "attention_bias/mlp_bias False)")
    act = config.get("hidden_act", "silu")
    if act != "silu":
        raise ValueError(f"unsupported Llama activation {act!r}")
    scaling = config.get("rope_scaling")
    rope_scaling = None
    if scaling:
        rt = scaling.get("rope_type", scaling.get("type"))
        if rt in ("llama3", "linear", "yarn"):
            rope_scaling = dict(scaling)
        elif rt != "default":
            # dynamic NTK and longrope would change every score if ignored
            raise ValueError(f"rope_scaling {scaling!r} is not supported "
                             "yet (plain/llama3/linear/yarn frequencies)")
    window = config.get("sliding_window")
    heads = int(config["num_attention_heads"])
    return dict(
        window=int(window) if window else None,
        rope_scaling=rope_scaling,
        vocab_size=int(config["vocab_size"]),
        embed_dim=int(config["hidden_size"]),
        num_heads=heads,
        num_kv_heads=int(config.get("num_key_value_heads", heads)),
        ffn_dim=int(config["intermediate_size"]),
        num_layers=int(config["num_hidden_layers"]),
        max_len=int(config.get("max_position_embeddings", 2048)),
        rope=True,
        rope_theta=float(config.get("rope_theta", 10000.0)),
        activation="swiglu",
        norm="rms",
        norm_eps=float(config.get("rms_norm_eps", 1e-6)),
        bias=False,
        tie_embeddings=bool(config.get("tie_word_embeddings", False)),
    )


def llama_state_dict_to_lm(hf_sd: Dict[str, Any],
                           num_layers: int) -> Dict[str, np.ndarray]:
    """HF Llama state dict -> our torch-convention LM state dict: q/k/v
    (and Qwen2's q/k/v biases) concatenate row-wise into the GQA
    ``in_proj_*``; the rest is a rename. ``rotary_emb.inv_freq`` buffers
    are ignored."""
    sd = dict(hf_sd)
    out: Dict[str, np.ndarray] = {
        "embedding.weight": _np(sd["model.embed_tokens.weight"]),
        "encoder.norm.weight": _np(sd["model.norm.weight"]),
    }
    if "lm_head.weight" in sd:
        out["lm_head.weight"] = _np(sd["lm_head.weight"])
    for i in range(num_layers):
        src, dst = f"model.layers.{i}", f"encoder.layers.{i}"
        attn = f"{src}.self_attn"
        out[f"{dst}.norm1.weight"] = _np(sd[f"{src}.input_layernorm.weight"])
        out[f"{dst}.norm2.weight"] = \
            _np(sd[f"{src}.post_attention_layernorm.weight"])
        out[f"{dst}.self_attn.in_proj_weight"] = np.concatenate(
            [_np(sd[f"{attn}.{x}_proj.weight"]) for x in "qkv"], axis=0)
        if f"{attn}.q_proj.bias" in sd:  # Qwen2's q/k/v biases
            out[f"{dst}.self_attn.in_proj_bias"] = np.concatenate(
                [_np(sd[f"{attn}.{x}_proj.bias"]) for x in "qkv"], axis=0)
        out[f"{dst}.self_attn.out_proj.weight"] = \
            _np(sd[f"{attn}.o_proj.weight"])
        out[f"{dst}.linear1.weight"] = _np(sd[f"{src}.mlp.gate_proj.weight"])
        out[f"{dst}.linear_gate.weight"] = _np(sd[f"{src}.mlp.up_proj.weight"])
        out[f"{dst}.linear2.weight"] = _np(sd[f"{src}.mlp.down_proj.weight"])
    return out


def load_llama(config: Dict[str, Any], state_dict: Dict[str, Any], *,
               device: DeviceLike = "cuda"):
    """A ``build_lm`` model on ``device`` from an HF Llama (or Mistral)
    config and state dict. A tied checkpoint carries no
    ``lm_head.weight``; an untied one must (``strict=not tied``)."""
    resolve_device(device)  # no card: refuse before any work
    kwargs = llama_lm_kwargs(config)
    ours = llama_state_dict_to_lm(state_dict, kwargs["num_layers"])
    return _build_loaded(kwargs, ours, not kwargs["tie_embeddings"], device)


# -------------------------------------------------------------------- Qwen2
def qwen2_lm_kwargs(config: Dict[str, Any]) -> Dict[str, Any]:
    """``build_lm`` arguments for an HF Qwen2 ``config.json`` dict: the
    Llama block with biased q/k/v projections (``qkv_bias=True``).

    Qwen2's ``sliding_window`` acts only with ``use_sliding_window``, and
    then on the layers from ``max_window_layers`` on; this builds uniform
    stacks, so all-sliding (0) and none-sliding (>= num_hidden_layers) map
    and a mix is refused."""
    act = config.get("hidden_act", "silu")
    if act != "silu":
        raise ValueError(f"unsupported Qwen2 activation {act!r}")
    window = None
    if config.get("use_sliding_window", False):
        n_layers = int(config["num_hidden_layers"])
        mwl = int(config.get("max_window_layers", 0))
        if mwl == 0:
            window = int(config["sliding_window"])
        elif mwl < n_layers:
            raise ValueError("Qwen2 mixed sliding-window layers "
                             "(0 < max_window_layers < num_hidden_layers) "
                             "are not mapped")
    base = dict(config)
    base.pop("sliding_window", None)  # handled above (Llama's differs)
    kwargs = llama_lm_kwargs(base)
    kwargs["window"] = window
    kwargs["qkv_bias"] = True
    return kwargs


def load_qwen2(config: Dict[str, Any], state_dict: Dict[str, Any], *,
               device: DeviceLike = "cuda"):
    """A ``build_lm`` model on ``device`` from an HF Qwen2 config and
    state dict (Llama's names plus the q/k/v biases)."""
    resolve_device(device)  # no card: refuse before any work
    kwargs = qwen2_lm_kwargs(config)
    ours = llama_state_dict_to_lm(state_dict, kwargs["num_layers"])
    return _build_loaded(kwargs, ours, not kwargs["tie_embeddings"], device)


# ------------------------------------------------------------------- export
def _layer_count(ours: Dict[str, np.ndarray]) -> int:
    return 1 + max(int(k.split(".")[2]) for k in ours
                   if k.startswith("encoder.layers."))


def export_gpt2_state_dict(model) -> Dict[str, np.ndarray]:
    """A GPT-2-shaped ``build_lm`` model (``pos="learned"``, tied, LayerNorm,
    biased) as an HF ``GPT2LMHeadModel`` state dict (``transformer.``
    prefix, ``Conv1D`` layout): the inverse of ``gpt2_state_dict_to_lm``."""
    ours = export_lm_state_dict(model)
    if "pos_embedding.weight" not in ours:
        raise ValueError("GPT-2 export needs build_lm(pos='learned') "
                         "(a trained wpe table)")
    if "lm_head.weight" in ours:
        raise ValueError("GPT-2 export needs tie_embeddings=True "
                         "(GPT-2 checkpoints carry no separate head)")
    out: Dict[str, np.ndarray] = {
        "transformer.wte.weight": ours["embedding.weight"],
        "transformer.wpe.weight": ours["pos_embedding.weight"],
        "transformer.ln_f.weight": ours["encoder.norm.weight"],
        "transformer.ln_f.bias": ours["encoder.norm.bias"],
        "lm_head.weight": ours["embedding.weight"],  # the tied duplicate
    }
    for i in range(_layer_count(ours)):
        src, dst = f"encoder.layers.{i}", f"transformer.h.{i}"
        out[f"{dst}.ln_1.weight"] = ours[f"{src}.norm1.weight"]
        out[f"{dst}.ln_1.bias"] = ours[f"{src}.norm1.bias"]
        out[f"{dst}.ln_2.weight"] = ours[f"{src}.norm2.weight"]
        out[f"{dst}.ln_2.bias"] = ours[f"{src}.norm2.bias"]
        out[f"{dst}.attn.c_attn.weight"] = \
            ours[f"{src}.self_attn.in_proj_weight"].T.copy()
        out[f"{dst}.attn.c_attn.bias"] = ours[f"{src}.self_attn.in_proj_bias"]
        out[f"{dst}.attn.c_proj.weight"] = \
            ours[f"{src}.self_attn.out_proj.weight"].T.copy()
        out[f"{dst}.attn.c_proj.bias"] = ours[f"{src}.self_attn.out_proj.bias"]
        out[f"{dst}.mlp.c_fc.weight"] = ours[f"{src}.linear1.weight"].T.copy()
        out[f"{dst}.mlp.c_fc.bias"] = ours[f"{src}.linear1.bias"]
        out[f"{dst}.mlp.c_proj.weight"] = ours[f"{src}.linear2.weight"].T.copy()
        out[f"{dst}.mlp.c_proj.bias"] = ours[f"{src}.linear2.bias"]
    return out


def export_llama_state_dict(model) -> Dict[str, np.ndarray]:
    """A Llama-shaped ``build_lm`` model (rope, rms, swiglu, bias-free)
    under HF ``LlamaForCausalLM`` names, q/k/v split back out of the GQA
    stack: the inverse of ``llama_state_dict_to_lm``."""
    ours = export_lm_state_dict(model)
    _, enc, _ = _lm_parts(model)
    out: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": ours["embedding.weight"],
        "model.norm.weight": ours["encoder.norm.weight"],
    }
    if "lm_head.weight" in ours:
        out["lm_head.weight"] = ours["lm_head.weight"]
    for i in range(_layer_count(ours)):
        src, dst = f"encoder.layers.{i}", f"model.layers.{i}"
        attn = enc._modules[f"layer{i}"].self_attn
        e, ekv = attn.embed_dim, attn._e_kv
        w = ours[f"{src}.self_attn.in_proj_weight"]
        out[f"{dst}.self_attn.q_proj.weight"] = w[:e]
        out[f"{dst}.self_attn.k_proj.weight"] = w[e:e + ekv]
        out[f"{dst}.self_attn.v_proj.weight"] = w[e + ekv:]
        out[f"{dst}.self_attn.o_proj.weight"] = \
            ours[f"{src}.self_attn.out_proj.weight"]
        out[f"{dst}.input_layernorm.weight"] = ours[f"{src}.norm1.weight"]
        out[f"{dst}.post_attention_layernorm.weight"] = \
            ours[f"{src}.norm2.weight"]
        out[f"{dst}.mlp.gate_proj.weight"] = ours[f"{src}.linear1.weight"]
        out[f"{dst}.mlp.up_proj.weight"] = ours[f"{src}.linear_gate.weight"]
        out[f"{dst}.mlp.down_proj.weight"] = ours[f"{src}.linear2.weight"]
    return out


def save_hf_checkpoint(model, path: str) -> str:
    """Write ``config.json`` and ``model.safetensors`` (F32) so that
    ``transformers`` and ``load_hf_checkpoint`` read the directory. The
    family follows from the model: RoPE + RMSNorm + SwiGLU is a Llama
    config (Mistral's with a window), a learned-position LayerNorm/gelu
    stack GPT-2's. A model whose activation its family's config cannot
    name, or a Qwen2-shaped one (``qkv_bias``), is refused. Returns the
    directory."""
    emb, enc, head = _lm_parts(model)
    layer0 = enc._modules["layer0"]
    mha = layer0.self_attn
    is_llama = mha.rope
    act = layer0.activation
    if is_llama and act != "swiglu":
        raise ValueError(f"Llama-family export needs activation='swiglu' "
                         f"(model has {act!r})")
    if not is_llama and act != "gelu":
        raise ValueError(f"GPT-2 export needs activation='gelu' "
                         f"(= HF gelu_new; model has {act!r})")
    if is_llama and mha.qkv_bias:
        raise ValueError("Qwen2-family export (qkv_bias=True) is not "
                         "implemented; a Llama config cannot carry the "
                         "q/k/v projection biases")
    os.makedirs(path, exist_ok=True)
    if is_llama:
        sd = export_llama_state_dict(model)
        window = mha.window
        config = {
            # a sliding window makes it a Mistral-shaped checkpoint
            "model_type": "mistral" if window else "llama",
            "architectures": ["MistralForCausalLM" if window
                              else "LlamaForCausalLM"],
            **({"sliding_window": int(window)} if window else {}),
            **({"rope_scaling": dict(mha.rope_scaling)}
               if mha.rope_scaling else {}),
            "vocab_size": int(emb.n_index),
            "hidden_size": int(mha.embed_dim),
            "intermediate_size": int(layer0.linear1.output_size),
            "num_hidden_layers": int(enc.num_layers),
            "num_attention_heads": int(mha.num_heads),
            "num_key_value_heads": int(mha.num_kv_heads),
            "max_position_embeddings": int(getattr(model, "lm_max_len",
                                                   2048)),
            "rms_norm_eps": float(layer0.norm1.eps),
            "rope_theta": float(mha.rope_theta),
            "hidden_act": "silu",
            "attention_bias": False,
            "mlp_bias": False,
            "tie_word_embeddings": isinstance(head, TiedLMHead),
            "torch_dtype": "float32",
        }
    else:
        sd = export_gpt2_state_dict(model)
        config = {
            "model_type": "gpt2",
            "architectures": ["GPT2LMHeadModel"],
            "vocab_size": int(emb.n_index),
            "n_positions": int(sd["transformer.wpe.weight"].shape[0]),
            "n_embd": int(mha.embed_dim),
            "n_layer": int(enc.num_layers),
            "n_head": int(mha.num_heads),
            "n_inner": int(layer0.linear1.output_size),
            "activation_function": "gelu_new",
            "layer_norm_epsilon": float(layer0.norm1.eps),
            "tie_word_embeddings": True,
            "torch_dtype": "float32",
        }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    return path


# ------------------------------------------------------- safetensors format
_NUMPY_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
                 "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1",
                 "BOOL": "?"}


def write_safetensors(fname: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write ``tensors`` as one safetensors file of F32 members: the 8-byte
    little-endian header length, the JSON header (padded with spaces to 8
    bytes, as the format's own writer does), then each tensor's bytes in
    order."""
    arrays = {k: np.ascontiguousarray(v, dtype="<f4")
              for k, v in tensors.items()}
    header, offset = {}, 0
    for k, a in arrays.items():
        header[k] = {"dtype": "F32", "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(fname, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for a in arrays.values():
            f.write(a.tobytes())


def read_safetensors(fname: str) -> Dict[str, np.ndarray]:
    """One safetensors file -> ``{name: numpy array}``: the numpy dtypes as
    they are, BF16 as f32; any other dtype raises ``ValueError``."""
    out: Dict[str, np.ndarray] = {}
    with open(fname, "rb") as f:
        (hdr_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hdr_len))
        base = 8 + hdr_len
        for k, meta in header.items():
            if k == "__metadata__":
                continue
            dt, shape = meta["dtype"], meta["shape"]
            if dt not in _NUMPY_DTYPES and dt != "BF16":
                raise ValueError(f"unsupported safetensors dtype {dt!r}")
            start, stop = meta["data_offsets"]
            buf = bytearray(stop - start)
            f.seek(base + start)
            f.readinto(buf)
            if dt == "BF16":
                out[k] = (torch.frombuffer(buf, dtype=torch.bfloat16)
                          .float().numpy().reshape(shape)
                          if buf else np.zeros(shape, np.float32))
            else:
                out[k] = np.frombuffer(buf, _NUMPY_DTYPES[dt]).reshape(shape)
    return out


def _read_hf_weights(path: str) -> Dict[str, Any]:
    """An HF checkpoint directory's weights: every ``*.safetensors`` file
    (one or many shards), else every ``pytorch_model*.bin``."""
    st = [f for f in sorted(os.listdir(path)) if f.endswith(".safetensors")]
    if st:
        out: Dict[str, Any] = {}
        for f in st:
            out.update(read_safetensors(os.path.join(path, f)))
        return out
    bins = [f for f in sorted(os.listdir(path)) if f.endswith(".bin")
            and f.startswith("pytorch_model")]
    if bins:
        out = {}
        for f in bins:
            out.update(torch.load(os.path.join(path, f), map_location="cpu",
                                  weights_only=True))
        return out
    raise FileNotFoundError(f"no .safetensors or pytorch_model*.bin in {path}")


def load_hf_checkpoint(path: str, *, device: DeviceLike = "cuda"):
    """Load an HF checkpoint directory (``config.json`` and its weights)
    into a ``build_lm`` model on ``device``, by ``config.json``'s
    ``model_type``: ``gpt2``, ``llama``/``mistral`` or ``qwen2``."""
    resolve_device(device)  # no card: refuse before reading gigabytes
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    sd = _read_hf_weights(path)
    mt = config.get("model_type", "")
    loader = {"gpt2": load_gpt2, "llama": load_llama, "mistral": load_llama,
              "qwen2": load_qwen2}.get(mt)
    if loader is None:
        raise ValueError(
            f"unsupported model_type {mt!r} (gpt2/llama/mistral/qwen2)")
    return loader(config, sd, device=device)
