"""The port's ``build_lm`` model options against the JAX package, on the CPU.

Each option (``pos="learned"``, ``norm_eps``, ``head_bias``, ``qkv_bias``,
``window``, ``rope_scaling`` of each type) builds a 2-layer model in both
packages; one set of weights, drawn with numpy from a seed, goes into both
through ``import_lm_state_dict``, and the same numpy ids through both.
``gelu_exact`` and the post-norm block are held at the
``TransformerEncoder`` level, the weights carried as parameter trees. The
sliding window's decode paths are in ``tests/test_torch_window_decode.py``.

Tolerances are ``tests/test_torch_lm_slice.py``'s: f32 log-probs within
1e-5 absolute plus 1e-5 relative (the two frameworks sum the same f32
products in other orders), greedy tokens identical; the int8 twin within
1e-2 absolute plus 2e-3 relative, with identical greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.interop.state_dict import import_lm_state_dict as jax_import
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.models.generation import generate as jax_generate
from bigdl_tpu.nn.attention import rope_rotate as jax_rope_rotate
from bigdl_tpu.nn.attention import scale_rope_freqs as jax_scale_rope_freqs
from bigdl_tpu.nn.quantized import quantize_model as jax_quantize_model
from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                flatten_tree,
                                                import_lm_state_dict,
                                                import_tree_state)
from bigdl_tpu_torch.models.generation import generate
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn.attention import (LearnedPositionalEncoding,
                                          MultiHeadAttention,
                                          TransformerEncoder, rope_rotate,
                                          scale_rope_freqs)
from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model

TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=2e-3, atol=1e-2)
V = 97
LLAMA = dict(embed_dim=64, num_heads=4, num_kv_heads=2, ffn_dim=128,
             num_layers=2, max_len=48, rope=True, activation="swiglu",
             norm="rms", bias=False)
GPT = dict(embed_dim=64, num_heads=4, ffn_dim=128, num_layers=2, max_len=48)
SCALINGS = {
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 16},
    "linear": {"rope_type": "linear", "factor": 2.0},
    "yarn": {"rope_type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 16},
}
OPTIONS = {
    "learned": dict(GPT, pos="learned", tie_embeddings=True),
    "norm_eps_layer": dict(GPT, norm_eps=1e-2, fused_head=True),
    "norm_eps_rms": dict(LLAMA, norm_eps=1e-2, tie_embeddings=True),
    "head_bias": dict(LLAMA, head_bias=True, fused_head=True),
    "qkv_bias": dict(LLAMA, qkv_bias=True, tie_embeddings=True),
    "window": dict(LLAMA, window=4, tie_embeddings=True),
    **{f"rope_{k}": dict(LLAMA, rope_scaling=v, fused_head=True)
       for k, v in SCALINGS.items()},
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(model, seed):
    """numpy weights from ``seed`` for every torch-convention name of
    ``model``: norm gains near 1, the rest N(0, 1/fan_in) (the tables
    N(0, 0.5))."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, arr in export_lm_state_dict(model).items():
        if "norm" in name and name.endswith("weight"):
            out[name] = 1.0 + 0.1 * rng.standard_normal(arr.shape)
        elif name in ("embedding.weight", "pos_embedding.weight"):
            out[name] = 0.5 * rng.standard_normal(arr.shape)
        else:
            out[name] = rng.standard_normal(arr.shape) / np.sqrt(arr.shape[-1])
    return {k: v.astype(np.float32) for k, v in out.items()}


def _pair(kw, seed=3):
    """(reference model, port model) with one set of numpy weights."""
    tm = build_lm(V, **kw, device="cpu", seed=0).evaluate_mode()
    sd = _weights(tm, seed)
    import_lm_state_dict(tm, sd)
    jm = jax_transformer.build_lm(V, **kw)
    jax_import(jm, sd)
    return jm.evaluate_mode(), tm


def _ids(b, s, seed=5):
    return np.random.default_rng(seed).integers(1, V + 1, (b, s))


def _jax_lp(jm, ids):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jm.forward(jnp.asarray(ids)))


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_matches_reference(name):
    jm, tm = _pair(OPTIONS[name])
    ids = _ids(2, 20)
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, _jax_lp(jm, ids), **TOL)


def test_options_change_the_function():
    """Each option is live: the same weights without it give other
    log-probs."""
    ids = _ids(1, 20)
    for name in ("qkv_bias", "window", "rope_llama3", "rope_yarn",
                 "rope_linear", "norm_eps_rms"):
        kw = dict(OPTIONS[name])
        _, tm = _pair(kw)
        sd = export_lm_state_dict(tm)
        for key in ("qkv_bias", "window", "rope_scaling", "norm_eps"):
            kw.pop(key, None)
        plain = build_lm(V, **kw, device="cpu").evaluate_mode()
        import_lm_state_dict(plain, {k: v for k, v in sd.items()
                                     if not k.endswith("in_proj_bias")})
        with torch.no_grad():
            a = tm(torch.as_tensor(ids))
            b = plain(torch.as_tensor(ids))
        assert (a - b).abs().max().item() > 1e-4, name


def _encoder_pair(**kw):
    e, h, f = 32, 4, 64
    jenc = jnn.TransformerEncoder(2, e, h, f, causal=True, **kw)
    tenc = TransformerEncoder(2, e, h, f, causal=True, **kw)
    tree = flatten_tree(jenc.parameter_tree())
    rng = np.random.default_rng(9)
    tree = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in tree.items()}
    import_tree_state(tenc, tree, {})
    params = jenc.parameter_tree()

    def put(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                put(v, f"{prefix}{k}.")
            else:
                node[k] = jnp.asarray(tree[f"{prefix}{k}"])
    put(params)
    jenc.load_parameter_tree(params)
    return jenc.evaluate_mode(), tenc.evaluate_mode()


@pytest.mark.parametrize("kw", [dict(activation="gelu_exact"),
                                dict(pre_norm=False),
                                dict(pre_norm=False, norm="rms",
                                     activation="gelu_exact", norm_eps=1e-3)],
                         ids=["gelu_exact", "post_norm",
                              "post_norm_rms_gelu_exact"])
def test_encoder_option_matches_reference(kw):
    jenc, tenc = _encoder_pair(**kw)
    x = np.random.default_rng(4).standard_normal((2, 10, 32)).astype(
        np.float32)
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jenc.forward(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    if kw.get("pre_norm") is False:
        assert tenc.final_norm is None


@pytest.mark.parametrize("name", sorted(SCALINGS))
def test_scaled_rope_matches_reference(name):
    sc = SCALINGS[name]
    half, theta = 16, 500000.0
    freqs = 1.0 / (theta ** (np.arange(half, dtype=np.float32) / half))
    got, att = scale_rope_freqs(torch.from_numpy(freqs), theta, sc)
    want, jatt = jax_scale_rope_freqs(jnp.asarray(freqs), theta, sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert att == pytest.approx(jatt)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7))
    np.testing.assert_allclose(
        rope_rotate(torch.from_numpy(x), torch.as_tensor(pos), theta,
                    sc).numpy(),
        np.asarray(jax_rope_rotate(jnp.asarray(x), jnp.asarray(pos), theta,
                                   sc)), **TOL)


@pytest.mark.parametrize("sc", [{"rope_type": "dynamic", "factor": 2.0},
                                {"type": "longrope", "factor": 2.0},
                                {"rope_type": "default"}])
def test_unsupported_rope_scaling_is_refused(sc):
    freqs = torch.ones(4)
    with pytest.raises(ValueError):
        jax_scale_rope_freqs(jnp.ones(4), 10000.0, sc)
    with pytest.raises(ValueError, match="rope_scaling"):
        scale_rope_freqs(freqs, 10000.0, sc)


@pytest.mark.parametrize("kw, match", [
    (dict(window=0, causal=True), "window must be"),
    (dict(window=4, causal=False), "requires causal"),
])
def test_window_is_validated(kw, match):
    with pytest.raises(ValueError):
        jnn.MultiHeadAttention(16, 2, **kw)
    with pytest.raises(ValueError, match=match):
        MultiHeadAttention(16, 2, **kw)


def test_unknown_pos_and_activation_are_refused():
    with pytest.raises(ValueError, match="unknown pos"):
        build_lm(V, **dict(GPT, pos="rotary"), device="cpu")
    with pytest.raises(ValueError, match="unknown activation"):
        build_lm(V, **dict(GPT, activation="tanh"), device="cpu")
    # under rope the reference ignores pos
    build_lm(V, **dict(LLAMA, pos="learned"), device="cpu")


def test_learned_positions_are_seeded_and_cast():
    a = build_lm(V, **OPTIONS["learned"], device="cpu", seed=4)
    b = build_lm(V, **OPTIONS["learned"], device="cpu", seed=4)
    wa = [m for m in a.modules() if isinstance(m, LearnedPositionalEncoding)]
    wb = [m for m in b.modules() if isinstance(m, LearnedPositionalEncoding)]
    assert len(wa) == 1 and torch.equal(wa[0].weight, wb[0].weight)
    assert abs(wa[0].weight.std().item() - 0.02) < 0.002
    twin = cast_model(a, torch.bfloat16, device="cpu")
    pe = [m for m in twin.modules()
          if isinstance(m, LearnedPositionalEncoding)][0]
    assert pe.weight.dtype == torch.bfloat16 and "weight" in pe._buffers


def test_bf16_twin_of_learned_model_holds_the_f32_tokens():
    _, tm = _pair(OPTIONS["learned"])
    ids = torch.as_tensor(_ids(1, 16))
    with torch.no_grad():
        got = cast_model(tm, torch.bfloat16, device="cpu")(ids).float()
        want = tm(ids)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert (got - want).abs().max().item() < 0.3


def test_int8_twin_with_qkv_bias_matches_reference():
    # E = 128: the reference runs its int8 kernel (K % 128 == 0) and not
    # its dequantize path, as in tests/test_torch_lm_slice.py
    jm, tm = _pair(dict(OPTIONS["qkv_bias"], embed_dim=128, ffn_dim=256))
    jq = jax_quantize_model(jm, compute_dtype=jnp.float32)
    tq = quantize_model(tm, torch.float32, device="cpu")
    biases = [m.in_proj_bias for m in tq.modules()
              if isinstance(m, MultiHeadAttention)]
    assert len(biases) == 2 and all(b.abs().max() > 0 for b in biases)
    ids = _ids(2, 8)
    with torch.no_grad():
        got = tq(torch.as_tensor(ids)).numpy()
    want = np.asarray(jq.forward(jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, **INT8_TOL)
    # greedy tokens: the argmax at every position, and generate's own
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    out = generate(tq, ids[:, :5], 3, greedy=True, device="cpu")
    with torch.no_grad():
        forced = tq(out).argmax(-1) + 1
    assert torch.equal(forced[:, 4:-1], out[:, 5:])


@pytest.mark.parametrize("name", ["qkv_bias", "learned"])
def test_int8_bf16_twin_with_biases_decodes(name):
    """At compute dtype bf16 a biased projection's output is f32 (the f32
    bias promotes it, in both packages) against the bf16 KV cache: the
    attention promotes, as the reference's einsums do. The decoded tokens
    are the teacher-forced forward's argmax (GQA and full MHA)."""
    _, tm = _pair(dict(OPTIONS[name], embed_dim=128, ffn_dim=256))
    tq = quantize_model(tm, torch.bfloat16, device="cpu")
    out = generate(tq, _ids(2, 6, seed=2), 5, greedy=True, device="cpu")
    with torch.no_grad():
        lp = tq(out).float()
    best = lp[:, 5:-1].max(-1).values
    took = lp[:, 5:-1].gather(-1, out[:, 6:, None] - 1)[..., 0]
    assert (best - took).max().item() <= 0.1
