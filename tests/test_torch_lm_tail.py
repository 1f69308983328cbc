"""``build_lm``'s unfused tail, ``TimeDistributed(Linear) + LogSoftMax``
(the reference's default), against the reference, on the CPU.

Weights cross with ``import_lm_state_dict`` (the tail's Linear carries the
``lm_head.*`` keys, as the fused head does). Tolerances are
``tests/test_torch_lm_slice.py``'s: f32 log-probs 1e-5 absolute plus 1e-5
relative, greedy tokens identical; the int8 twin (compute dtype f32;
widths of 128, so that the reference takes its kernel's arithmetic too)
1e-2 absolute plus 2e-3 relative with identical greedy tokens; the bf16
twins of both packages against each other at the same int8 tolerance on
probabilities (bf16 keeps about three significant digits of the logits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.models.generation import generate as jax_generate
from bigdl_tpu.nn.quantized import cast_model as jax_cast_model
from bigdl_tpu.nn.quantized import quantize_model as jax_quantize_model
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                import_lm_state_dict)
from bigdl_tpu_torch.models.generation import generate
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn import LogSoftMax, TimeDistributed
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear, cast_model,
                                          quantize_model)
from bigdl_tpu_torch.ops import int8_matmul

torch.set_num_threads(1)

V = 500
CONFIGS = {
    # the reference's defaults: sinusoidal positions, gelu, LayerNorm
    "default": dict(embed_dim=128, num_heads=4, ffn_dim=256, num_layers=2,
                    max_len=64),
    # --llamaBlock of apps/transformer.py: the untied log-prob tail
    "llama": dict(embed_dim=128, num_heads=4, num_kv_heads=2, ffn_dim=256,
                  num_layers=2, max_len=64, rope=True, activation="swiglu",
                  norm="rms", bias=False),
}
TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=2e-3, atol=1e-2)
_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        manual_seed(11)
        jm = jax_transformer.build_lm(V, **CONFIGS[name]).evaluate_mode()
        tm = build_lm(V, **CONFIGS[name], device="cpu", seed=0)
        import_lm_state_dict(tm, jax_export(jm))
        _CACHE[name] = (jm, tm.evaluate_mode())
    return _CACHE[name]


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(1, V + 1, (b, s))


def _jax_lp(jm, ids):
    return np.asarray(jm.predict(jnp.asarray(ids, jnp.float32)),
                      np.float32)


def _port_lp(tm, ids):
    with torch.inference_mode():
        return tm(torch.as_tensor(ids)).float().numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tail_structure_and_state_dict(name):
    jm, tm = _pair(name)
    assert isinstance(tm[-2], TimeDistributed) and isinstance(tm[-1],
                                                              LogSoftMax)
    assert isinstance(tm[-2].inner, Linear)
    ref, got = jax_export(jm), export_lm_state_dict(tm)
    assert sorted(got) == sorted(ref) and "lm_head.weight" in got
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logprobs_match(name):
    jm, tm = _pair(name)
    ids = _ids(2, 16, seed=1)
    np.testing.assert_allclose(_port_lp(tm, ids), _jax_lp(jm, ids), **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("s0", [1, 6])
def test_greedy_tokens_match(name, s0):
    jm, tm = _pair(name)
    prompt = _ids(2, s0, seed=2 + s0)
    want = np.asarray(jax_generate(jm, jnp.asarray(prompt, jnp.float32), 8,
                                   greedy=True)).astype(np.int64)
    got = generate(tm, prompt, 8, greedy=True, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_generation_slices_the_tail_to_the_last_position():
    _, tm = _pair("llama")
    seen = []
    hook = tm[-2].inner.register_forward_hook(
        lambda m, i, o: seen.append(tuple(i[0].shape)))
    try:
        generate(tm, _ids(2, 5, seed=4), 3, greedy=True, device="cpu")
    finally:
        hook.remove()
    assert seen == [(2, 128)] * 3      # (B * 1 position, E) every forward


def test_two_timedistributed_modules_are_refused():
    _, tm = _pair("default")
    from bigdl_tpu_torch.nn.containers import Sequential
    twice = Sequential().add(tm).add(TimeDistributed(Linear(V, V)))
    with pytest.raises(ValueError, match="TimeDistributed"):
        generate(twice, _ids(1, 3), 2, greedy=True, device="cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int8_twin_matches_reference(name):
    jm, tm = _pair(name)
    jq = jax_quantize_model(jm, compute_dtype=jnp.float32)
    tq = quantize_model(tm, torch.float32, device="cpu")
    assert isinstance(tq[-2].inner, QuantizedLinear)
    ids = _ids(2, 16, seed=3)
    before = int8_matmul.DEQUANT_CALLS.value
    np.testing.assert_allclose(_port_lp(tq, ids), _jax_lp(jq, ids),
                               **INT8_TOL)
    assert int8_matmul.DEQUANT_CALLS.value == before   # 32 rows: the kernel's
    prompt = _ids(2, 5, seed=10)
    want = np.asarray(jax_generate(jq, jnp.asarray(prompt, jnp.float32), 8,
                                   greedy=True)).astype(np.int64)
    np.testing.assert_array_equal(
        generate(tq, prompt, 8, greedy=True, device="cpu").numpy(), want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bf16_twin_matches_reference(name):
    jm, tm = _pair(name)
    jb = jax_cast_model(jm)
    tb = cast_model(tm, torch.bfloat16, device="cpu")
    assert list(tb.parameters()) == []
    ids = _ids(2, 8, seed=9)
    got, want = _port_lp(tb, ids), _jax_lp(jb, ids)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.exp(got), np.exp(want), **INT8_TOL)


def test_trains_with_the_time_distributed_criterion():
    """A few SGD steps through ``Optimizer`` on the synthetic grammar: the
    tail's log-probs feed ``TimeDistributedCriterion(ClassNLLCriterion())``
    and the loss falls."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                              TimeDistributedCriterion)
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    model = build_lm(32, 32, 2, 64, num_layers=1, max_len=64, device="cpu",
                     seed=0)
    ds = DataSet.array(synthetic_corpus(64, 16, 32), seed=0) >> \
        SampleToBatch(8)
    opt = Optimizer(model, ds, TimeDistributedCriterion(ClassNLLCriterion()),
                    device="cpu")
    opt.set_optim_method(SGD(learningrate=0.05, momentum=0.9))
    opt.set_end_when(Trigger.max_epoch(3))
    opt.optimize()
    losses = [h["loss"] for h in opt.history]
    assert np.isfinite(losses).all() and np.mean(losses[-4:]) < losses[0]
