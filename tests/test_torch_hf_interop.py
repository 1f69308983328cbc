"""The port's HF checkpoint interop (``bigdl_tpu_torch/interop/hf.py``)
against the JAX package's and against live ``transformers``, on the CPU.

Each tiny HF model (2 layers, E = 32) is built by ``transformers`` and given
weights drawn with numpy from a seed (q/k/v biases included); its state
dict then goes through the port's loader, the reference's loader and
``transformers`` itself, with the same numpy ids. Bounds: the port against
the reference within 1e-5 absolute plus 1e-5 relative (f32 log-probs,
``tests/test_torch_lm_slice.py``'s ``TOL``); the port against
``transformers`` within 5e-5, the reference's own bound
(``tests/test_hf_interop.py``). Also the vendored
``tests/resources/hf_tiny_gpt2/`` against its golden log-probs. The
directory format, the safetensors reader and writer and the refusals are
in ``tests/test_torch_hf_checkpoint_dir.py``.
"""

import os

# transformers would otherwise import TensorFlow, where it is installed,
# for seconds of nothing
os.environ.setdefault("USE_TF", "0")

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.interop import hf as jhf
from bigdl_tpu_torch.interop import hf

transformers = pytest.importorskip("transformers")

RES = os.path.join(os.path.dirname(__file__), "resources", "hf_tiny_gpt2")
TOL = dict(rtol=1e-5, atol=1e-5)
HF_BOUND = 5e-5
SMALL = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=64, rms_norm_eps=1e-5,
             rope_theta=10000.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(model, seed):
    """Give every parameter of an HF model numpy N(0, 0.2) values from
    ``seed`` (norm gains 1 + that); returns the model in eval mode."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            val = 0.2 * rng.standard_normal(tuple(p.shape))
            if "norm" in name or name.split(".")[-2].startswith("ln"):
                val = 1.0 + val
            p.copy_(torch.from_numpy(val.astype(np.float32)))
    return model.eval()


def _hf(kind, seed=0, **kw):
    """(config dict, HF model) of a tiny ``kind`` model."""
    if kind == "gpt2":
        cfg = transformers.GPT2Config(vocab_size=97, n_positions=64,
                                      n_embd=32, n_layer=2, n_head=4, **kw)
        cls = transformers.GPT2LMHeadModel
    else:
        args = dict(SMALL, **kw)
        cfg_cls, cls = {
            "llama": (transformers.LlamaConfig,
                      transformers.LlamaForCausalLM),
            "mistral": (transformers.MistralConfig,
                        transformers.MistralForCausalLM),
            "qwen2": (transformers.Qwen2Config,
                      transformers.Qwen2ForCausalLM)}[kind]
        cfg = cfg_cls(vocab_size=89, attn_implementation="eager", **args)
    torch.manual_seed(seed)
    return cfg.to_dict(), _seeded(cls(cfg), seed)


def _hf_lp(model, ids):
    with torch.no_grad():
        return torch.log_softmax(model(torch.as_tensor(ids)).logits,
                                 -1).numpy()


def _port_lp(model, hf_ids):
    with torch.no_grad():
        return model(torch.as_tensor(hf.to_framework_ids(hf_ids))).numpy()


def _ref_lp(model, hf_ids):
    with jax.default_matmul_precision("highest"):
        return np.asarray(model.evaluate_mode().forward(
            jhf.to_framework_ids(hf_ids)))


CASES = {
    "gpt2": ("gpt2", {}, "load_gpt2"),
    "gpt2_gelu_exact": ("gpt2", dict(activation_function="gelu"),
                        "load_gpt2"),
    "llama_gqa_untied": ("llama", {}, "load_llama"),
    "llama_tied": ("llama", dict(tie_word_embeddings=True,
                                 num_key_value_heads=4), "load_llama"),
    "llama3_scaled": ("llama", dict(rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16}),
        "load_llama"),
    "linear_scaled": ("llama", dict(rope_scaling={"rope_type": "linear",
                                                  "factor": 4.0}),
                      "load_llama"),
    "yarn_scaled": ("llama", dict(rope_scaling={
        "rope_type": "yarn", "factor": 4.0,
        "original_max_position_embeddings": 16}), "load_llama"),
    "mistral_window": ("mistral", dict(sliding_window=4), "load_llama"),
    "qwen2_untied": ("qwen2", {}, "load_qwen2"),
    "qwen2_tied": ("qwen2", dict(tie_word_embeddings=True), "load_qwen2"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_reference_and_transformers(case):
    kind, kw, loader = CASES[case]
    config, model = _hf(kind, seed=len(case), **kw)
    sd = model.state_dict()
    ids = np.random.default_rng(1).integers(0, config["vocab_size"], (2, 14))
    ours = getattr(hf, loader)(config, sd, device="cpu")
    got = _port_lp(ours, ids)
    assert np.abs(got - _hf_lp(model, ids)).max() < HF_BOUND
    ref = getattr(jhf, loader)(config, sd)
    np.testing.assert_allclose(got, _ref_lp(ref, ids), **TOL)


def test_qkv_biases_and_window_are_carried():
    config, model = _hf("qwen2", seed=3)
    ours = hf.load_qwen2(config, model.state_dict(), device="cpu")
    mha = ours[1]._modules["layer0"].self_attn
    attn = model.model.layers[0].self_attn
    want = torch.cat([attn.q_proj.bias, attn.k_proj.bias, attn.v_proj.bias])
    assert torch.equal(mha.in_proj_bias.detach(), want.detach())
    assert "out_proj_bias" not in mha._parameters
    config, model = _hf("mistral", seed=4, sliding_window=4)
    ours = hf.load_llama(config, model.state_dict(), device="cpu")
    assert ours[1]._modules["layer1"].self_attn.window == 4


def test_windowed_greedy_generation_equals_transformers():
    from bigdl_tpu_torch.models.generation import generate
    config, model = _hf("mistral", seed=2, sliding_window=3)
    ours = hf.load_llama(config, model.state_dict(), device="cpu")
    prompt = np.random.default_rng(10).integers(0, 89, (1, 6))
    with torch.no_grad():
        want = model.generate(torch.as_tensor(prompt), max_new_tokens=8,
                              do_sample=False, pad_token_id=0).numpy()
    for rolling in (False, True):
        out = generate(ours, hf.to_framework_ids(prompt), 8, greedy=True,
                       rolling_cache=rolling, device="cpu")
        got = hf.to_hf_ids(out.numpy())[:, :want.shape[1]]
        np.testing.assert_array_equal(got, want)


def test_vendored_fixture_holds_golden_logprobs():
    ids = np.load(os.path.join(RES, "golden_input_ids.npy"))
    gold = np.load(os.path.join(RES, "golden_logprobs.npy"))
    model = hf.load_hf_checkpoint(RES, device="cpu")
    assert np.abs(_port_lp(model, ids) - gold).max() < HF_BOUND


def test_id_helpers_round_trip():
    ids = np.array([[0, 5, 49]])
    assert np.array_equal(hf.to_hf_ids(hf.to_framework_ids(ids)), ids)
    assert hf.to_framework_ids(ids).min() == 1
