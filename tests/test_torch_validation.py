"""The port's validation methods, evaluation loop and ``Metrics``
(``bigdl_tpu_torch/optim/validation.py``, ``evaluator.py``, ``metrics.py``)
against the reference's, on the CPU.

The same seeded outputs and targets go through both packages' methods:
counts must be equal and values within 1e-6 relative (f32 sums in other
orders). ``evaluate_batches`` runs with a short tail batch, which both
pad to the first batch's shape and slice off before scoring; the
``Evaluator`` runs the same tiny LMs (the Llama recipe and the fused-head
variant, whose eval output is log-probs) with weights carried across.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.base import MiniBatch as JaxMiniBatch
from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.optim import Evaluator as JaxEvaluator
from bigdl_tpu.optim import Metrics as JaxMetrics
from bigdl_tpu.optim import Predictor as JaxPredictor
from bigdl_tpu.optim import validation as jv
from bigdl_tpu.optim.evaluator import evaluate_batches as jax_evaluate
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.base import MiniBatch, Sample
from bigdl_tpu_torch.interop.state_dict import import_lm_state_dict
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.optim import (Evaluator, Loss, Metrics, Perplexity,
                                   Predictor, Top1Accuracy, Top5Accuracy)
from bigdl_tpu_torch.optim import validation as pv
from bigdl_tpu_torch.optim.evaluator import evaluate_batches, evaluating
from bigdl_tpu_torch.telemetry import MetricsRegistry, render_prometheus

REL = 1e-6
V = 96
LLAMA = dict(embed_dim=32, num_heads=4, num_kv_heads=2, ffn_dim=64,
             num_layers=2, max_len=32, rope=True, activation="swiglu",
             norm="rms", bias=False, tie_embeddings=True)
GPT = dict(embed_dim=32, num_heads=4, ffn_dim=64, num_layers=2, max_len=32,
           fused_head=True)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _scores(seed, n=37, c=10, ties=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 4, (n, c)).astype(np.float32) if ties
         else rng.standard_normal((n, c)).astype(np.float32))
    y = rng.integers(1, c + 1, n).astype(np.float32)
    return x, y


def _both(pm, jm, out, tgt):
    """(port result, reference result) of one method on the same arrays."""
    got = pm.apply(torch.as_tensor(out), torch.as_tensor(tgt))
    want = jm.apply(jnp.asarray(out), jnp.asarray(tgt))
    return got, want


def _check(got, want):
    assert type(got).__name__ == type(want).__name__
    g_num, g_n = got.state()
    w_num, w_n = want.state()
    assert g_n == w_n
    np.testing.assert_allclose(g_num, w_num, rtol=REL)
    np.testing.assert_allclose(got.result()[0], want.result()[0], rtol=REL)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["Top1Accuracy", "Top5Accuracy"])
def test_topk_matches_reference(name, seed, ties):
    out, tgt = _scores(seed, ties=ties)
    got, want = _both(getattr(pv, name)(), getattr(jv, name)(), out, tgt)
    assert (got.correct, got.count) == (want.correct, want.count)
    assert got == want


def test_topk_single_row_and_few_classes():
    out, tgt = _scores(5, n=1, c=3)
    for name in ("Top1Accuracy", "Top5Accuracy"):
        got, want = _both(getattr(pv, name)(), getattr(jv, name)(),
                          out[0], tgt[:1])
        assert got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_classnll_matches_reference(seed):
    out, tgt = _scores(seed)
    got, want = _both(Loss(), jv.Loss(), _log_softmax(out), tgt)
    _check(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_time_distributed_matches_reference(seed):
    rng = np.random.default_rng(seed)
    out = _log_softmax(rng.standard_normal((3, 7, 11)))
    tgt = rng.integers(1, 12, (3, 7)).astype(np.float32)
    got, want = _both(
        Loss(nn.TimeDistributedCriterion(nn.ClassNLLCriterion())),
        jv.Loss(jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())),
        out, tgt)
    _check(got, want)


@pytest.mark.parametrize("ignore", [None, 1, 0])
@pytest.mark.parametrize("seed", [0, 1])
def test_perplexity_matches_reference(seed, ignore):
    rng = np.random.default_rng(seed)
    out = _log_softmax(rng.standard_normal((4, 9, 13)))
    tgt = rng.integers(1, 14, (4, 9)).astype(np.float32)
    if ignore is not None:
        tgt[:, -3:] = ignore   # padding, inside the vocabulary or not
    got, want = _both(Perplexity(ignore), jv.Perplexity(ignore), out, tgt)
    _check(got, want)
    assert got.count == (tgt.size if ignore is None
                         else int((tgt != ignore).sum()))


def test_batch_result_stays_on_the_device_side():
    out, tgt = _scores(3)
    for m in (Top1Accuracy(), Loss(), Perplexity()):
        o = torch.as_tensor(_log_softmax(out))
        if isinstance(m, Perplexity):
            o = o[None]
        t = torch.as_tensor(tgt)[None] if isinstance(m, Perplexity) \
            else torch.as_tensor(tgt)
        v, c = m.batch_result(o, t)
        assert torch.is_tensor(v) and torch.is_tensor(c)


def test_results_merge_as_the_reference():
    a, b = pv.AccuracyResult(3, 5), pv.AccuracyResult(4, 10)
    ja, jb = jv.AccuracyResult(3, 5), jv.AccuracyResult(4, 10)
    assert (a + b).result() == (ja + jb).result()
    assert repr(a + b) == repr(ja + jb)
    for cls in ("LossResult", "PerplexityResult"):
        p = getattr(pv, cls)(2.5, 4) + getattr(pv, cls)(1.5, 2)
        j = getattr(jv, cls)(2.5, 4) + getattr(jv, cls)(1.5, 2)
        assert p.result() == j.result() and repr(p) == repr(j)
        assert getattr(pv, cls).from_state(*p.state()).result() == p.result()


# ------------------------------------------------------------ the batch loop
W = np.random.default_rng(7).standard_normal((6, 5)).astype(np.float32)


def _batches(sizes, seed=11, mini=MiniBatch):
    rng = np.random.default_rng(seed)
    return [mini(rng.standard_normal((n, 6)).astype(np.float32),
                 rng.integers(1, 6, n).astype(np.float32)) for n in sizes]


@pytest.mark.parametrize("sizes", [[8, 8, 3], [8], [5, 5, 5, 1]])
def test_evaluate_batches_with_short_tail_matches_reference(sizes):
    methods = [Top1Accuracy(), Top5Accuracy(), Loss()]
    jmethods = [jv.Top1Accuracy(), jv.Top5Accuracy(), jv.Loss()]
    seen = []

    def fwd(x):
        seen.append(x.shape[0])
        return torch.log_softmax(x @ torch.as_tensor(W), -1)

    got, n = evaluate_batches(fwd, _batches(sizes), methods,
                              torch.device("cpu"))
    want, jn = jax_evaluate(
        lambda p, b, x: jax.nn.log_softmax(x @ p, -1), jnp.asarray(W), {},
        _batches(sizes, mini=JaxMiniBatch), jmethods)
    assert n == jn == sum(sizes)
    assert seen == [sizes[0]] * len(sizes)   # the tail ran padded
    for g, w in zip(got, want):
        _check(g, w)


def test_evaluate_batches_counts_samples_and_apply_only_methods():
    class ApplyOnly(pv.ValidationMethod):
        name = "ApplyOnly"

        def apply(self, output, target):
            return pv.AccuracyResult(int(output.shape[0]), 1)

    rng = np.random.default_rng(3)
    samples = [Sample(rng.standard_normal(6).astype(np.float32),
                      np.float32(rng.integers(1, 6))) for _ in range(4)]

    def fwd(x):
        return torch.log_softmax(x @ torch.as_tensor(W), -1)

    (top1, own), n = evaluate_batches(fwd, samples,
                                      [Top1Accuracy(), ApplyOnly()],
                                      torch.device("cpu"))
    assert n == 4 and top1.count == 4
    assert (own.correct, own.count) == (4, 4)


def _lm_pair(cfg):
    manual_seed(13)
    jm = jax_transformer.build_lm(V, **cfg)
    tm = build_lm(V, **cfg, device="cpu", seed=0)
    import_lm_state_dict(tm, jax_export(jm))
    return jm, tm


def _lm_samples(n=10, s=12, seed=2):
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    return synthetic_corpus(n, s, V, seed=seed)


@pytest.mark.parametrize("cfg", ["llama", "gpt"])
def test_evaluator_on_lm_matches_reference(cfg):
    jm, tm = _lm_pair({"llama": LLAMA, "gpt": GPT}[cfg])
    samples = _lm_samples()
    methods = [Perplexity(),
               Loss(nn.TimeDistributedCriterion(nn.ClassNLLCriterion()))]
    jmethods = [jv.Perplexity(),
                jv.Loss(jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()))]
    tm.train()
    got = Evaluator(tm, batch_size=4, device="cpu").test(samples, methods)
    assert tm.training   # the mode is restored
    want = JaxEvaluator(jm, batch_size=4).test(samples, jmethods)
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_allclose(g.result()[0], w.result()[0], rtol=1e-5)
        assert g.result()[1] == w.result()[1]


def test_predictor_matches_reference():
    jm, tm = _lm_pair(LLAMA)
    samples = _lm_samples(n=5)
    got = Predictor(tm, batch_size=2, device="cpu").predict_class(samples)
    want = JaxPredictor(jm.evaluate_mode(), batch_size=2).predict_class(
        samples)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_evaluating_restores_mode_after_an_error():
    net = nn.Sequential().add(nn.Linear(2, 2))
    net.train()
    with pytest.raises(RuntimeError):
        with evaluating(net):
            assert not net.training and not torch.is_grad_enabled()
            raise RuntimeError("boom")
    assert net.training and torch.is_grad_enabled()


def test_evaluator_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(nn.Sequential().add(nn.Linear(2, 2)))


# ------------------------------------------------------------------ Metrics
def _drive(m):
    m.add("computing time", 0.5)
    m.add("computing time", 0.25)
    m.set("data wait", 3.0, parallel=4)
    m.add("validation time", 1.0)
    return [m.get("computing time"), m.get("data wait"), m.get("absent"),
            m.value("data wait"), m.value("validation time"), m.summary()]


def test_metrics_match_reference():
    from bigdl_tpu.telemetry import MetricsRegistry as JaxRegistry
    assert _drive(Metrics(MetricsRegistry())) == _drive(
        JaxMetrics(JaxRegistry()))


def test_metrics_land_in_the_registry_and_leave_with_the_instance():
    import gc
    reg = MetricsRegistry()
    m = Metrics(reg)
    m.add("x", 2.0)
    scope = m._scope
    line = f'bigdl_legacy_metric{{scope="{scope}",name="x"}} 2'
    assert line in render_prometheus(reg).splitlines()
    del m
    gc.collect()
    assert f'scope="{scope}"' not in render_prometheus(reg)
