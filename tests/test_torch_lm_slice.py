"""The port's LM serving slice against the JAX package, on the CPU.

Weights cross from the reference to the port through
``export_lm_state_dict`` -> ``import_lm_state_dict``; the same numpy
inputs go through both. Tolerances (f32 throughout):

- log-probs: 1e-5 absolute plus 1e-5 relative. The logits of these random
  tied-embedding models reach tens (N(0, 1) embeddings), and the two
  frameworks sum the same f32 products in different orders;
- greedy tokens: identical;
- int8 twin (compute dtype f32): 1e-2 absolute plus 2e-3 relative (these
  log-probs reach -180). Both run the reference
  kernel's arithmetic (x rounded to bf16, exact products, f32 sums) on the
  same int8 weights, but the bf16 rounding of each activation turns an f32
  difference of ~1e-7 upstream into a whole bf16 step (2^-8 relative) where
  a value sits on a rounding boundary, and that step propagates. Every call
  here has M <= 32 rows, where the reference on CPU runs its Pallas kernel
  (in interpret mode) and not its dequantize path.
"""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.models.generation import filter_top_k as jax_filter_top_k
from bigdl_tpu.models.generation import filter_top_p as jax_filter_top_p
from bigdl_tpu.models.generation import generate as jax_generate
from bigdl_tpu.nn.quantized import quantize_model as jax_quantize_model
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                import_lm_state_dict)
from bigdl_tpu_torch.models.generation import (filter_top_k, filter_top_p,
                                               generate)
from bigdl_tpu_torch.models.lm_server import LMServer, make_http_server
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
from bigdl_tpu_torch.ops import flash_attention, int8_matmul

torch.set_num_threads(1)

V = 1000
LLAMA = dict(embed_dim=128, num_heads=4, num_kv_heads=2, ffn_dim=256,
             num_layers=2, max_len=64, rope=True, activation="swiglu",
             norm="rms", bias=False, tie_embeddings=True)
GPT = dict(embed_dim=128, num_heads=4, ffn_dim=256, num_layers=2,
           max_len=64, fused_head=True)
CONFIGS = {"llama": LLAMA, "gpt": GPT}
TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=2e-3, atol=1e-2)

_CACHE = {}


def _pair(name):
    """(jax model, port model) with the same weights; built once."""
    if name not in _CACHE:
        manual_seed(11)
        jm = jax_transformer.build_lm(V, **CONFIGS[name]).evaluate_mode()
        tm = build_lm(V, **CONFIGS[name], device="cpu", seed=0)
        import_lm_state_dict(tm, jax_export(jm))
        _CACHE[name] = (jm, tm.evaluate_mode())
    return _CACHE[name]


def _int8_pair(name):
    key = name + "-int8"
    if key not in _CACHE:
        jm, tm = _pair(name)
        _CACHE[key] = (jax_quantize_model(jm, compute_dtype=jnp.float32),
                       quantize_model(tm, torch.float32, device="cpu"))
    return _CACHE[key]


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(1, V + 1, (b, s))


def _jax_logprobs(jm, ids):
    return np.asarray(jm.predict(jnp.asarray(ids, jnp.float32)))


def _port_logprobs(tm, ids):
    with torch.no_grad():
        return tm(torch.as_tensor(ids)).float().numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_roundtrip(name):
    jm, tm = _pair(name)
    ref = jax_export(jm)
    got = export_lm_state_dict(tm)
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logprobs_match(name):
    jm, tm = _pair(name)
    ids = _ids(2, 16, seed=1)
    np.testing.assert_allclose(_port_logprobs(tm, ids), _jax_logprobs(jm, ids),
                               **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("s0", [1, 5])
def test_greedy_tokens_match(name, s0):
    jm, tm = _pair(name)
    prompt = _ids(2, s0, seed=2 + s0)
    ref = np.asarray(jax_generate(jm, jnp.asarray(prompt, jnp.float32), 8,
                                  greedy=True)).astype(np.int64)
    got = generate(tm, prompt, 8, greedy=True, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int8_twin_logprobs_match(name):
    jq, tq = _int8_pair(name)
    ids = _ids(2, 16, seed=3)
    before = int8_matmul.DEQUANT_CALLS.value
    np.testing.assert_allclose(_port_logprobs(tq, ids), _jax_logprobs(jq, ids),
                               **INT8_TOL)
    # 32 rows: every projection took the kernel's arithmetic
    assert int8_matmul.DEQUANT_CALLS.value == before


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int8_twin_greedy_tokens_match(name):
    jq, tq = _int8_pair(name)
    prompt = _ids(2, 5, seed=10)
    ref = np.asarray(jax_generate(jq, jnp.asarray(prompt, jnp.float32), 8,
                                  greedy=True)).astype(np.int64)
    got = generate(tq, prompt, 8, greedy=True, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


def test_quantize_model_leaves_source_and_freezes_twin():
    _, tm = _pair("llama")
    tq = quantize_model(tm, torch.float32, device="cpu")
    assert list(tq.parameters()) == []
    assert len(list(tm.parameters())) > 0
    q_bufs = [n for n, b in tq.named_buffers() if b.dtype == torch.int8]
    # per layer: in_proj, out_proj, linear1/2/gate; plus the embedding
    assert len(q_bufs) == 2 * 5 + 1


def test_cast_model_bf16_twin():
    jm, tm = _pair("llama")
    tb = cast_model(tm, torch.bfloat16, device="cpu")
    assert list(tb.parameters()) == []
    assert {b.dtype for b in tb.buffers()} == {torch.bfloat16}
    ids = _ids(2, 8, seed=9)
    got = _port_logprobs(tb, ids)
    ref = _port_logprobs(tm, ids)
    assert np.isfinite(got).all()
    # bf16 keeps ~3 significant digits of logits in the tens
    assert np.abs(np.exp(got) - np.exp(ref)).max() < 0.1


def test_lm_server_answers_equal_generate():
    _, tm = _pair("llama")
    server = LMServer(tm, max_batch=4, batch_timeout_ms=200,
                      max_new_tokens=6, greedy=True, device="cpu")
    try:
        prompts = [list(_ids(1, 5, seed=20 + i)[0]) for i in range(3)]
        prompts.append(list(_ids(1, 3, seed=30)[0]))
        results = [None] * len(prompts)

        def client(i):
            results[i] = server.submit(prompts[i], timeout=60)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for p, r in zip(prompts, results):
            want = generate(tm, [p], 6, greedy=True, device="cpu")[0]
            assert r == want[len(p):].tolist()
        assert server.batches_served == 2  # one per prompt length
    finally:
        server.close()


def test_http_server_generate_and_health():
    _, tm = _pair("llama")
    server = LMServer(tm, max_batch=2, max_new_tokens=4, greedy=True,
                      device="cpu")
    http = make_http_server(server, "127.0.0.1", 0)
    worker = threading.Thread(target=http.serve_forever, daemon=True)
    worker.start()
    base = f"http://127.0.0.1:{http.server_address[1]}"
    try:
        prompt = [5, 17, 300]
        req = urllib.request.Request(
            base + "/generate", data=json.dumps({"prompt": prompt}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            ids = json.loads(resp.read())["ids"]
        want = generate(tm, [prompt], 4, greedy=True, device="cpu")[0]
        assert ids == want[3:].tolist()
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["batches_served"] == 1
        with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            text = resp.read().decode()
        # the server wrote the process-global registry: one batch at least
        assert "bigdl_lmserver_batches_total" in text
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/nothing", timeout=60)
        assert err.value.code == 404
    finally:
        http.shutdown()
        http.server_close()
        server.close()
        worker.join(timeout=10)


def test_top_k_sampling_stays_in_top_k():
    _, tm = _pair("llama")
    prompt = _ids(2, 4, seed=40)
    k = 3
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        out = generate(tm, prompt, 5, top_k=k, generator=gen,
                       device="cpu").numpy()
        for t in range(5):
            lp = _port_logprobs(tm, out[:, :4 + t])[:, -1]
            top = np.argsort(-lp, axis=-1)[:, :k] + 1
            for row in range(2):
                assert out[row, 4 + t] in top[row]


def test_top_p_and_repetition_options_run():
    _, tm = _pair("llama")
    gen = torch.Generator().manual_seed(0)
    out = generate(tm, _ids(2, 3, seed=41), 6, top_p=0.9, temperature=0.7,
                   repetition_penalty=1.3, generator=gen, device="cpu")
    assert out.shape == (2, 9)
    assert int(out.min()) >= 1 and int(out.max()) <= V


def test_eos_freezes_rows_and_min_new_tokens():
    _, tm = _pair("llama")
    prompt = _ids(2, 4, seed=42)
    greedy = generate(tm, prompt, 6, greedy=True, device="cpu").numpy()
    eos = int(greedy[0, 4 + 1])  # row 0 emits it at step 1
    out = generate(tm, prompt, 6, greedy=True, eos_id=eos, pad_id=7,
                   device="cpu").numpy()
    ref = np.asarray(jax_generate(_pair("llama")[0],
                                  jnp.asarray(prompt, jnp.float32), 6,
                                  greedy=True, eos_id=eos, pad_id=7))
    np.testing.assert_array_equal(out, ref.astype(np.int64))
    assert (out[0, 6:] == 7).all()
    late = generate(tm, prompt, 6, greedy=True, eos_id=eos,
                    min_new_tokens=3, device="cpu").numpy()
    assert eos not in late[:, 4:7]


@pytest.mark.parametrize("k", [0, 1, 3, 50])
def test_filter_top_k_matches_reference(k):
    lp = np.log(np.random.default_rng(k).dirichlet(np.ones(60), 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        filter_top_k(torch.from_numpy(lp), k).numpy(),
        np.asarray(jax_filter_top_k(jnp.asarray(lp), k)))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9])
def test_filter_top_p_matches_reference(p):
    lp = np.log(np.random.default_rng(7).dirichlet(np.ones(60), 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        filter_top_p(torch.from_numpy(lp), p).numpy(),
        np.asarray(jax_filter_top_p(jnp.asarray(lp), p)))


def test_prefill_takes_plain_core_on_cpu():
    _, tm = _pair("llama")
    before = flash_attention.LAUNCHES.value
    generate(tm, _ids(1, 6, seed=43), 2, greedy=True, device="cpu")
    assert flash_attention.LAUNCHES.value == before


@pytest.mark.parametrize("bad", [dict(seq_axis="seq"),
                                 dict(seq_mode="ulysses"),
                                 dict(seq_layout="zigzag"),
                                 dict(moe_experts=4), dict(moe_k=1)])
def test_build_lm_rejects_unported_options(bad):
    """Every option is ported: the context-parallel ones build the model
    with its attention sharded over the axis; the MoE ones build the
    reference's routed FFN on the gelu recipe, and with the Llama recipe's
    swiglu raise the reference's ValueError."""
    kw = dict(LLAMA, **bad)
    if not any(k.startswith("moe") for k in bad):
        from bigdl_tpu_torch.nn import MultiHeadAttention
        model = build_lm(V, **kw, device="cpu")
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                for k, v in bad.items():
                    assert getattr(m, k) == v
        return
    from bigdl_tpu_torch.parallel.expert import MoE
    if "moe_experts" in bad:
        with pytest.raises(ValueError, match="swiglu FFN does not compose"):
            build_lm(V, **kw, device="cpu")
        with pytest.raises(ValueError, match="swiglu FFN does not compose"):
            jax_transformer.build_lm(V, **kw)
    model = build_lm(V, **dict(GPT, **dict(dict(moe_experts=4), **bad)),
                     device="cpu")
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    assert len(moes) == GPT["num_layers"]
    assert all(m.n_experts == 4 and m.k == bad.get("moe_k", 2)
               for m in moes)


@pytest.mark.parametrize("kw, exc, match", [
    # the rolling cache is ported: a model without a window is refused
    # with the reference's ValueError
    (dict(num_beams=2, rolling_cache=True), ValueError, "sliding window"),
    (dict(rolling_cache=True), ValueError, "sliding window"),
    # ported: a mesh of one decodes as without one
    (dict(mesh="local"), None, None)])
def test_generate_rejects_unported_options(kw, exc, match):
    _, tm = _pair("llama")
    if exc is None:
        from bigdl_tpu_torch.parallel import MeshTopology
        mesh = MeshTopology(data=1).build(device="cpu")
        want = generate(tm, _ids(1, 2), 2, greedy=True, device="cpu")
        got = generate(tm, _ids(1, 2), 2, greedy=True, device="cpu",
                       mesh=mesh)
        assert torch.equal(got, want)
        return
    with pytest.raises(exc, match=match):
        generate(tm, _ids(1, 2), 2, device="cpu", **kw)
    if exc is ValueError:
        with pytest.raises(ValueError, match="sliding window"):
            jax_generate(_pair("llama")[0], jnp.asarray(_ids(1, 2)), 2, **kw)
