"""The port's HF checkpoint directories against the JAX package's and
``transformers``, on the CPU: ``save_hf_checkpoint`` read back by the port
(bit-equal parameters), by the reference and by ``transformers``'
``from_pretrained``; the reference's directories read by the port; a
``pytorch_model.bin`` checkpoint; the port's own safetensors reader and
writer against the ``safetensors`` package (F32, F16, BF16, I64 and empty
members; an F8 member refused); and every refusal the reference makes,
with its exception type. Bounds as in ``tests/test_torch_hf_interop.py``:
1e-5 absolute plus 1e-5 relative against the reference, 5e-5 against
``transformers``.
"""

import json

import numpy as np
import pytest
import torch

from bigdl_tpu.interop import hf as jhf
from bigdl_tpu.interop.state_dict import import_lm_state_dict as jax_import
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu_torch.interop import hf
from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                import_lm_state_dict)
from bigdl_tpu_torch.models.transformer import build_lm
from test_torch_hf_interop import (HF_BOUND, SMALL, TOL, _hf, _hf_lp,
                                   _port_lp, _ref_lp)

transformers = pytest.importorskip("transformers")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- directory format
def _port_model(kind, seed=5, **kw):
    base = dict(vocab_size=83, embed_dim=32, num_heads=4, ffn_dim=64,
                num_layers=2, max_len=48, tie_embeddings=True)
    if kind == "gpt2":
        base.update(pos="learned")
    else:
        base.update(rope=True, norm="rms", activation="swiglu", bias=False,
                    num_kv_heads=2)
    base.update(kw)
    model = build_lm(**base, device="cpu", seed=seed).evaluate_mode()
    rng = np.random.default_rng(seed)
    import_lm_state_dict(model, {
        k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in export_lm_state_dict(model).items()})
    return model


DIR_MODELS = {"gpt2": ("gpt2", {}),
              "llama_untied": ("llama", dict(tie_embeddings=False)),
              "mistral": ("llama", dict(window=5)),
              "llama3": ("llama", dict(rope_scaling={
                  "rope_type": "llama3", "factor": 4.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 16}))}


@pytest.mark.parametrize("name", sorted(DIR_MODELS))
def test_port_directory_reads_in_reference_and_transformers(name, tmp_path):
    kind, kw = DIR_MODELS[name]
    model = _port_model(kind, **kw)
    hf.save_hf_checkpoint(model, str(tmp_path))
    ids = np.random.default_rng(2).integers(0, 83, (1, 12))
    want = _port_lp(model, ids)
    back = hf.load_hf_checkpoint(str(tmp_path), device="cpu")
    for a, b in zip(export_lm_state_dict(model).values(),
                    export_lm_state_dict(back).values()):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(_ref_lp(jhf.load_hf_checkpoint(str(tmp_path)),
                                       ids), want, **TOL)
    auto = transformers.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), attn_implementation="eager").eval()
    assert np.abs(_hf_lp(auto, ids) - want).max() < HF_BOUND


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_reference_directory_reads_in_port(kind, tmp_path):
    port = _port_model(kind, seed=6, **({"window": 4} if kind == "llama"
                                        else {}))
    kw = dict(vocab_size=83, embed_dim=32, num_heads=4, ffn_dim=64,
              num_layers=2, max_len=48, tie_embeddings=True)
    kw.update(dict(pos="learned") if kind == "gpt2" else dict(
        rope=True, norm="rms", activation="swiglu", bias=False,
        num_kv_heads=2, window=4))
    ref = jax_transformer.build_lm(**kw)
    jax_import(ref, export_lm_state_dict(port))
    jhf.save_hf_checkpoint(ref, str(tmp_path))
    ours = hf.load_hf_checkpoint(str(tmp_path), device="cpu")
    ids = np.random.default_rng(3).integers(0, 83, (2, 10))
    np.testing.assert_allclose(_port_lp(ours, ids), _ref_lp(ref, ids), **TOL)


def test_pytorch_bin_checkpoint_loads(tmp_path):
    config, model = _hf("llama", seed=8)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(config, model_type="llama"), f)
    torch.save(model.state_dict(), tmp_path / "pytorch_model.bin")
    ours = hf.load_hf_checkpoint(str(tmp_path), device="cpu")
    ids = np.random.default_rng(4).integers(0, 89, (1, 9))
    assert np.abs(_port_lp(ours, ids) - _hf_lp(model, ids)).max() < HF_BOUND


# --------------------------------------------------------------- safetensors
def test_reader_matches_the_safetensors_package(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    st_numpy = pytest.importorskip("safetensors.numpy")
    g = torch.Generator().manual_seed(0)
    mixed = {"f32": torch.randn(3, 5, generator=g),
             "f16": torch.randn(4, generator=g).half(),
             "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
             "i64": torch.arange(6).reshape(2, 3),
             "empty": torch.zeros(0, 4, dtype=torch.bfloat16)}
    fname = str(tmp_path / "mixed.safetensors")
    st_torch.save_file(mixed, fname)
    got = hf.read_safetensors(fname)
    want = st_torch.load_file(fname)
    assert set(got) == set(want)
    for k, v in want.items():
        ref = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        assert got[k].dtype == ref.dtype and got[k].shape == ref.shape, k
        np.testing.assert_array_equal(got[k], ref)
    plain = {k: v.numpy() for k, v in mixed.items() if k in ("f32", "f16",
                                                           "i64")}
    fname = str(tmp_path / "numpy.safetensors")
    st_numpy.save_file(plain, fname)
    for k, v in hf.read_safetensors(fname).items():
        np.testing.assert_array_equal(v, plain[k])


def test_writer_is_read_by_the_safetensors_package(tmp_path):
    st_numpy = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(5)
    tensors = {"a.weight": rng.standard_normal((7, 3)).astype(np.float32),
               "b": rng.standard_normal(5)}
    fname = str(tmp_path / "model.safetensors")
    hf.write_safetensors(fname, tensors)
    back = st_numpy.load_file(fname)
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v.astype(np.float32))


def test_unsupported_dtype_is_refused(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    fname = str(tmp_path / "f8.safetensors")
    st_torch.save_file({"x": torch.zeros(4).to(torch.float8_e4m3fn)}, fname)
    with pytest.raises(ValueError, match="unsupported safetensors dtype"):
        hf.read_safetensors(fname)


# ------------------------------------------------------------------ refusals
def _gpt2_cfg(**kw):
    return dict(_hf("gpt2")[0], **kw)


def _llama_cfg(**kw):
    return dict(SMALL, vocab_size=64, model_type="llama", **kw)


def _qwen2_cfg(**kw):
    return dict(dict(SMALL, vocab_size=64, model_type="qwen2",
                     hidden_act="silu", num_hidden_layers=4), **kw)


KWARG_REFUSALS = {
    "gpt2_activation": ("gpt2_lm_kwargs",
                        lambda: _gpt2_cfg(activation_function="relu")),
    "gpt2_inverse_layer_idx": ("gpt2_lm_kwargs", lambda: _gpt2_cfg(
        scale_attn_by_inverse_layer_idx=True)),
    "gpt2_unscaled": ("gpt2_lm_kwargs",
                      lambda: _gpt2_cfg(scale_attn_weights=False)),
    "llama_attention_bias": ("llama_lm_kwargs",
                             lambda: _llama_cfg(attention_bias=True)),
    "llama_mlp_bias": ("llama_lm_kwargs", lambda: _llama_cfg(mlp_bias=True)),
    "llama_activation": ("llama_lm_kwargs",
                         lambda: _llama_cfg(hidden_act="gelu")),
    "llama_dynamic_rope": ("llama_lm_kwargs", lambda: _llama_cfg(
        rope_scaling={"rope_type": "dynamic", "factor": 2.0})),
    "llama_longrope": ("llama_lm_kwargs", lambda: _llama_cfg(
        rope_scaling={"type": "longrope", "factor": 2.0})),
    "qwen2_activation": ("qwen2_lm_kwargs",
                         lambda: _qwen2_cfg(hidden_act="relu")),
    "qwen2_mixed_windows": ("qwen2_lm_kwargs", lambda: _qwen2_cfg(
        use_sliding_window=True, sliding_window=16, max_window_layers=2)),
}


@pytest.mark.parametrize("name", sorted(KWARG_REFUSALS))
def test_config_refusals_match_reference(name):
    fn, cfg = KWARG_REFUSALS[name]
    with pytest.raises(ValueError):
        getattr(jhf, fn)(cfg())
    with pytest.raises(ValueError):
        getattr(hf, fn)(cfg())


@pytest.mark.parametrize("cfg", [
    _qwen2_cfg(use_sliding_window=True, sliding_window=16,
               max_window_layers=4),
    _qwen2_cfg(use_sliding_window=True, sliding_window=16,
               max_window_layers=0),
    _qwen2_cfg(sliding_window=16),
    _llama_cfg(sliding_window=8, rope_scaling={"rope_type": "default"}),
    _llama_cfg(rope_scaling={"rope_type": "yarn", "factor": 2.0}),
], ids=["qwen2_mwl_all", "qwen2_mwl_zero", "qwen2_inert", "llama_default",
        "llama_yarn"])
def test_build_arguments_equal_reference(cfg):
    fn = "qwen2_lm_kwargs" if cfg["model_type"] == "qwen2" else \
        "llama_lm_kwargs"
    assert getattr(hf, fn)(cfg) == getattr(jhf, fn)(cfg)


EXPORT_REFUSALS = {
    "gpt2_sinusoidal": ("export_gpt2_state_dict",
                        dict(vocab_size=50, embed_dim=32, num_heads=4,
                             ffn_dim=32, num_layers=1, tie_embeddings=True)),
    "gpt2_untied": ("export_gpt2_state_dict",
                    dict(vocab_size=50, embed_dim=32, num_heads=4,
                         ffn_dim=32, num_layers=1, pos="learned")),
    "save_gelu_exact": ("save_hf_checkpoint",
                        dict(vocab_size=50, embed_dim=32, num_heads=4,
                             ffn_dim=32, num_layers=1, pos="learned",
                             tie_embeddings=True, activation="gelu_exact")),
    "save_rope_gelu": ("save_hf_checkpoint",
                       dict(vocab_size=50, embed_dim=32, num_heads=4,
                            ffn_dim=32, num_layers=1, rope=True,
                            norm="rms", tie_embeddings=True)),
    "save_qwen2": ("save_hf_checkpoint",
                   dict(vocab_size=50, embed_dim=32, num_heads=4, ffn_dim=32,
                        num_layers=1, rope=True, norm="rms",
                        activation="swiglu", bias=False, qkv_bias=True,
                        tie_embeddings=True)),
}


@pytest.mark.parametrize("name", sorted(EXPORT_REFUSALS))
def test_export_refusals_match_reference(name, tmp_path):
    fn, kw = EXPORT_REFUSALS[name]
    args = (str(tmp_path),) if fn == "save_hf_checkpoint" else ()
    with pytest.raises(ValueError):
        getattr(jhf, fn)(jax_transformer.build_lm(**kw), *args)
    with pytest.raises(ValueError):
        getattr(hf, fn)(build_lm(**kw, device="cpu"), *args)


def test_directory_refusals_match_reference(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "gpt2"}, f)
    for mod in (jhf, hf):
        with pytest.raises(FileNotFoundError):
            mod.load_hf_checkpoint(str(tmp_path), **(
                {"device": "cpu"} if mod is hf else {}))
    hf.write_safetensors(str(tmp_path / "model.safetensors"),
                         {"x": np.zeros(2, np.float32)})
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "bert"}, f)
    with pytest.raises(ValueError, match="unsupported model_type"):
        jhf.load_hf_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="unsupported model_type"):
        hf.load_hf_checkpoint(str(tmp_path), device="cpu")


def test_strict_loads_match_reference():
    """An untied Llama checkpoint without its head is refused (strict); a
    Qwen2 one without q/k/v biases loads them as zeros, as the reference's
    non-strict load keeps its zero-initialised biases."""
    config, model = _hf("llama", seed=9)
    sd = {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"}
    with pytest.raises(KeyError):
        jhf.load_llama(config, sd)
    with pytest.raises(KeyError):
        hf.load_llama(config, sd, device="cpu")
    config, model = _hf("qwen2", seed=9, tie_word_embeddings=True)
    sd = {k: v for k, v in model.state_dict().items()
          if not k.endswith("_proj.bias")}
    ours = hf.load_qwen2(config, sd, device="cpu")
    ids = np.random.default_rng(6).integers(0, 89, (1, 8))
    np.testing.assert_allclose(_port_lp(ours, ids),
                               _ref_lp(jhf.load_qwen2(config, sd), ids),
                               **TOL)


def test_non_strict_import_ignores_only_extra_keys():
    """``strict=False`` ignores a key the model lacks (a tied head's
    ``lm_head.weight``) but still refuses a missing one, and leaves the
    model as it was; a missing q/k/v bias reaches the loaders only."""
    model = _port_model("llama", seed=11)
    sd = export_lm_state_dict(model)
    extra = dict(sd, **{"lm_head.weight": np.zeros((83, 32), np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        import_lm_state_dict(model, extra)
    import_lm_state_dict(model, extra, strict=False)
    before = export_lm_state_dict(model)
    name = sorted(sd)[0]
    missing = {k: v + 1 for k, v in extra.items() if k != name}
    for strict in (True, False):
        with pytest.raises(KeyError, match="missing"):
            import_lm_state_dict(model, missing, strict=strict)
    after = export_lm_state_dict(model)
    assert all(np.array_equal(before[k], after[k]) for k in before)
