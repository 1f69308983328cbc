"""The port's LM training slice against the JAX package's, on the CPU.

Two tiny LMs, the Llama recipe (RoPE, RMSNorm, SwiGLU, GQA, tied
embeddings) and the LayerNorm/gelu/sinusoidal ``fused_head`` variant, are
built in the reference, and their weights are carried into the port with
``export_lm_state_dict`` -> ``import_lm_state_dict``. Both then train 20
iterations of f32 ``AdamW`` with ``FusedLMHeadCriterion`` through their own
``Optimizer``, on a dataset holding exactly one batch of the reference's
synthetic-grammar samples: each epoch's shuffle only reorders rows inside
that batch, which the mean loss does not see, so both sides see the same
data without sharing a generator.

Tolerances: per-step losses within 1e-4 (the reference's are read from its
log lines, printed to 5 decimals); final weights within 1e-4 absolute plus
1e-3 relative (Adam divides by the root of the second moment, so a 1e-7
difference in a near-zero gradient can move that element's step by a
visible fraction of the learning rate). The one exception, the key
projection's bias, whose exact gradient is zero, is explained in
``test_final_weights_match``.
"""

import logging
import re

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.apps.transformer import _synthetic_corpus
from bigdl_tpu.dataset.base import DataSet as JaxDataSet
from bigdl_tpu.dataset.base import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.optim import AdamW as JaxAdamW
from bigdl_tpu.optim import Optimizer as JaxOptimizer
from bigdl_tpu.optim import Trigger as JaxTrigger
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.apps.transformer import synthetic_corpus
from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                import_lm_state_dict)
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn import Dropout, FusedLMHeadCriterion
from bigdl_tpu_torch.ops import flash_attention
from bigdl_tpu_torch.ops.precision import DtypePolicy
from bigdl_tpu_torch.optim import AdamW, Optimizer, Trigger

torch.set_num_threads(1)

V, B, S, STEPS = 96, 4, 16, 20
LLAMA = dict(embed_dim=32, num_heads=4, num_kv_heads=2, ffn_dim=64,
             num_layers=2, max_len=32, rope=True, activation="swiglu",
             norm="rms", bias=False, tie_embeddings=True)
GPT = dict(embed_dim=32, num_heads=4, ffn_dim=64, num_layers=2, max_len=32,
           fused_head=True)
CONFIGS = {"llama": LLAMA, "gpt": GPT}
ADAMW = dict(learningrate=3e-3, weightdecay=0.01)
LOSS_TOL = 1e-4
WEIGHT_TOL = dict(rtol=1e-3, atol=1e-4)
_LOSS_RE = re.compile(r"Loss is (-?[0-9.]+)\.")

_CACHE = {}


def _trained(name, caplog):
    """(reference losses, port losses, reference weights, port weights)
    after 20 iterations from shared initial weights; computed once."""
    if name in _CACHE:
        return _CACHE[name]
    manual_seed(11)
    jmodel = jax_transformer.build_lm(V, **CONFIGS[name])
    tmodel = build_lm(V, **CONFIGS[name], device="cpu", seed=0)
    import_lm_state_dict(tmodel, jax_export(jmodel))

    jds = JaxDataSet.array(_synthetic_corpus(B, S, V)) >> JaxSampleToBatch(B)
    jopt = (JaxOptimizer(jmodel, jds, jnn.FusedLMHeadCriterion())
            .set_optim_method(JaxAdamW(**ADAMW))
            .set_end_when(JaxTrigger.max_iteration(STEPS)))
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="bigdl_tpu.optim"):
        jopt.optimize()
    ref_losses = [float(m.group(1)) for m in map(_LOSS_RE.search,
                                                 caplog.messages) if m]

    tds = DataSet.array(synthetic_corpus(B, S, V), seed=0) >> SampleToBatch(B)
    topt = (Optimizer(tmodel, tds, FusedLMHeadCriterion(), device="cpu")
            .set_optim_method(AdamW(**ADAMW))
            .set_end_when(Trigger.max_iteration(STEPS)))
    topt.optimize()
    port_losses = [h["loss"] for h in topt.history]
    _CACHE[name] = (ref_losses, port_losses, jax_export(jmodel),
                    export_lm_state_dict(tmodel))
    return _CACHE[name]


def test_synthetic_corpus_matches_reference():
    ref = _synthetic_corpus(3, 9, V, seed=5)
    got = synthetic_corpus(3, 9, V, seed=5)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.feature, r.feature)
        np.testing.assert_array_equal(g.label, r.label)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_per_step_losses_match(name, caplog):
    ref, got, _, _ = _trained(name, caplog)
    assert len(ref) == len(got) == STEPS
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOSS_TOL)
    assert np.mean(got[-5:]) < got[0]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_final_weights_match(name, caplog):
    _, _, ref, got = _trained(name, caplog)
    assert sorted(ref) == sorted(got)
    e = CONFIGS[name]["embed_dim"]
    for k in ref:
        if k.endswith("in_proj_bias"):
            # the key bias shifts every logit of a query row alike, so the
            # softmax never sees it: its gradient is 0 in exact arithmetic
            # and roundoff in both frameworks, which Adam's normalised step
            # turns into moves of up to lr per step. Held to that bound;
            # the query and value biases to the tolerance.
            kb = slice(e, 2 * e)
            assert np.abs(got[k][kb] - ref[k][kb]).max() <= (
                2 * ADAMW["learningrate"] * STEPS)
            got[k][kb] = ref[k][kb]
        np.testing.assert_allclose(got[k], ref[k], **WEIGHT_TOL, err_msg=k)


def test_bf16_policy_trains():
    model = build_lm(V, **LLAMA, device="cpu", seed=3)
    ds = DataSet.array(synthetic_corpus(B, S, V), seed=0) >> SampleToBatch(B)
    opt = (Optimizer(model, ds, FusedLMHeadCriterion(), device="cpu")
           .set_optim_method(AdamW(**ADAMW)).set_precision("bf16")
           .set_gradient_clipping_by_l2_norm(1.0)
           .set_end_when(Trigger.max_iteration(8)))
    opt.optimize()
    losses = [h["loss"] for h in opt.history]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0]
    # the masters stay f32 and the bf16 compute copies leave no grads behind
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert all(p.grad is None for p in model.parameters())


def test_bf16_compute_copy_keeps_the_autograd_link():
    model = build_lm(V, **LLAMA, device="cpu", seed=3).train()
    params = dict(model.named_parameters())
    compute = DtypePolicy.bf16().cast_params_for_compute(params)
    assert {p.dtype for p in compute.values()} == {torch.bfloat16}
    ids = torch.as_tensor(np.random.default_rng(5).integers(1, V + 1, (2, 8)))
    out = torch.func.functional_call(model, compute, (ids,))
    assert out[0].dtype == out[1].dtype == torch.bfloat16
    FusedLMHeadCriterion()(out, ids).backward()
    for name, p in params.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name


def _dropout_pair(cfg):
    base = build_lm(V, **cfg, device="cpu", seed=4)
    drop = build_lm(V, **cfg, dropout=0.1, device="cpu", seed=4)
    import_lm_state_dict(drop, export_lm_state_dict(base))
    return base, drop


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dropout_eval_equals_dropout_free_model(name):
    base, drop = _dropout_pair(CONFIGS[name])
    ids = torch.as_tensor(np.random.default_rng(1).integers(1, V + 1, (2, 8)))
    with torch.no_grad():
        want = base.evaluate_mode()(ids)
        got = drop.evaluate_mode()(ids)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    drops = [m for m in drop.modules() if isinstance(m, Dropout)]
    # per block: residual dropout and the attention-probability dropout;
    # plus the embedding stream (the PE's own, or a separate one under RoPE)
    assert len(drops) == 2 * CONFIGS[name]["num_layers"] + 1
    assert all(m.p == 0.1 for m in drops)


def test_dropout_training_mode_takes_plain_core():
    _, drop = _dropout_pair(LLAMA)
    drop.train()
    ids = torch.as_tensor(np.random.default_rng(2).integers(1, V + 1, (2, 8)))
    before = flash_attention.LAUNCHES.value
    hidden, w = drop(ids)
    assert flash_attention.LAUNCHES.value == before
    again, _ = drop(ids)
    assert not torch.equal(hidden, again)  # fresh masks each call
    assert w is drop[0].weight            # the live tied parameter


def test_dropout_kept_share():
    m = Dropout(0.3).manual_seed(5)
    x = torch.ones(200_000)
    y = m(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.005
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))
    assert torch.equal(m.evaluate_mode()(x), x)
    torch.testing.assert_close(Dropout(0.3).manual_seed(5)(x), y)


def test_tied_gradient_sums_both_uses():
    model = build_lm(V, **LLAMA, device="cpu", seed=6)
    ids = torch.as_tensor(np.random.default_rng(3).integers(1, V + 1, (2, 8)))
    tgt = torch.as_tensor(np.random.default_rng(4).integers(1, V + 1, (2, 8)))
    model.train()
    FusedLMHeadCriterion()(model(ids), tgt).backward()
    full = model[0].weight.grad.clone()
    # the head's share alone: the same loss with the lookup detached
    model.zero_grad()
    emb = model[0]
    hidden = model[1](emb.weight.detach()[emb._ids(ids)])
    FusedLMHeadCriterion()(model[2](hidden), tgt).backward()
    head_only = emb.weight.grad
    assert not torch.allclose(full, head_only)
    # rows of ids the batch never looks up get the head's gradient only
    unused = sorted(set(range(V)) - set((ids - 1).flatten().tolist()))
    torch.testing.assert_close(full[unused], head_only[unused])


@pytest.mark.parametrize("setter", ["set_profiling"])
def test_unported_setters_raise(setter, tmp_path):
    """The setters that waited for their port (the name is kept from
    then) work now: ``set_profiling`` returns the optimizer, and the run
    writes a trace of its window."""
    model = build_lm(V, **LLAMA, device="cpu", seed=0)
    ds = DataSet.array(synthetic_corpus(B, S, V)) >> SampleToBatch(B)
    opt = Optimizer(model, ds, FusedLMHeadCriterion(), device="cpu")
    assert getattr(opt, setter)(str(tmp_path), 2, 1) is opt
    opt.set_end_when(Trigger.max_iteration(2)).optimize()
    assert (tmp_path / "trace.json").is_file()


def test_distributed_dataset_raises():
    """A distributed dataset trains data-parallel (``DistriOptimizer``,
    here a mesh of one); a model-parallel mesh axis raises, naming its
    ROADMAP item."""
    from bigdl_tpu_torch.parallel import DistriOptimizer, MeshTopology
    ds = DataSet.array(synthetic_corpus(B, S, V), distributed=True)
    assert ds.is_distributed() and ds.size() == B
    model = build_lm(V, **LLAMA, device="cpu", seed=0)
    opt = Optimizer(model, ds >> SampleToBatch(B), FusedLMHeadCriterion(),
                    device="cpu")
    assert isinstance(opt, DistriOptimizer)
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP A\.4 \(distributed plane: model"):
        Optimizer(model, ds, FusedLMHeadCriterion(), device="cpu",
                  topology=MeshTopology(data=1, tensor=2))


def test_sample_to_batch_remainder_matches_reference():
    samples = synthetic_corpus(10, 4, V)
    for drop in (True, False):
        got = DataSet.array(samples) >> SampleToBatch(4, drop_remainder=drop)
        ref = (JaxDataSet.array(samples)
               >> JaxSampleToBatch(4, drop_remainder=drop))
        got_b = list(got.data(train=False))
        ref_b = list(ref.data(train=False))
        assert [b.size() for b in got_b] == [b.size() for b in ref_b]
        for g, r in zip(got_b, ref_b):
            np.testing.assert_array_equal(g.data, r.data)
            np.testing.assert_array_equal(g.labels, r.labels)


def test_shuffle_is_seeded():
    orders = []
    for _ in range(2):
        ds = DataSet.array(list(range(20)), seed=3)
        ds.shuffle()
        orders.append(list(ds.data(train=True)))
    assert orders[0] == orders[1] and orders[0] != list(range(20))
    assert sorted(orders[0]) == list(range(20))


def test_lookup_ids_clip_in_training():
    # ids outside 1..V are clipped into range, never rejected, and their
    # gradient lands on the clipped rows
    model = build_lm(V, **LLAMA, device="cpu", seed=8).train()
    emb = model[0]
    ids = torch.tensor([[0, 1, V, V + 7]])
    out = emb(ids)
    torch.testing.assert_close(out[0, 0], emb.weight[0].detach())
    torch.testing.assert_close(out[0, 3], emb.weight[V - 1].detach())
    out.sum().backward()
    rows = (emb.weight.grad.abs().sum(-1) > 0).nonzero().flatten().tolist()
    assert rows == [0, V - 1]
