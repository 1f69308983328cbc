"""``Optimizer.set_steps_per_dispatch(k)`` against the JAX package's, on the
CPU.

A 2-layer, E=32 Llama-recipe LM is built in the reference and its weights
are carried into the port (``export_lm_state_dict`` ->
``import_lm_state_dict``). Both train on the same seeded corpus of three
batches per epoch, in a fixed order (the datasets' shuffles are switched
off, since the two packages draw their permutations from different
generators), with f32 ``AdamW``, until ``max_iteration(7)``.

- Per-iteration losses and final weights match the reference's run with
  the same k in {1, 2, 4}, within ``test_torch_lm_train.py``'s tolerances
  (``LOSS_TOL``, ``WEIGHT_TOL``); the port's k > 1 matches its k = 1
  exactly, since on the CPU a window runs its iterations eagerly one by
  one.
- Window lengths, read from both packages' ``train.dispatch`` spans, are
  equal: each epoch's end closes a window, and ``max_iteration`` ends the
  last one early. The trigger-bounded windows are in
  ``test_torch_steps_per_dispatch_triggers.py``.
- Each optim method's update from its ``step_scalars`` (what a captured
  window reads from a device tensor) tracks its Python-float update.
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
from bigdl_tpu.telemetry import tracing as jax_tracing
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.apps.transformer import synthetic_corpus
from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                import_lm_state_dict)
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn import FusedLMHeadCriterion
from bigdl_tpu_torch.optim import (SGD, Adagrad, Adam, AdamW, Optimizer, Poly,
                                   Trigger)
from bigdl_tpu_torch.telemetry import tracing

V, B, S, BATCHES = 96, 4, 16, 3
# test_torch_lm_train.py's Llama config. At E=64 the port's losses lie up
# to 1.35e-4 from the reference's by the fourth iteration (f32 roundoff of
# a loss summed over 16 positions, 4.6e-6 relative), above LOSS_TOL; at
# E=32 up to 5.5e-5 over the 7 iterations
CFG = dict(embed_dim=32, num_heads=4, num_kv_heads=2, ffn_dim=64,
           num_layers=2, max_len=32, rope=True, activation="swiglu",
           norm="rms", bias=False, tie_embeddings=True)
ADAMW = dict(learningrate=3e-3, weightdecay=0.01)
LOSS_TOL = 1e-4                              # test_torch_lm_train.py:59-60
WEIGHT_TOL = dict(rtol=1e-3, atol=1e-4)
STEPS = 7          # epochs of 3, 3 and 1: max_iteration ends the third

_CACHE = {}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _LossLines(logging.Handler):
    """The losses of the reference's log lines (printed to 5 decimals)."""
    _PATTERN = re.compile(r"Loss is (-?[0-9.]+)\.")

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        m = self._PATTERN.search(record.getMessage())
        if m:
            self.losses.append(float(m.group(1)))


def _train(side, model, k, trigger):
    """Train one package's model; returns its window lengths (from its
    tracer's ``train.dispatch`` spans) and per-iteration losses."""
    if side == "ref":
        ds = (JaxDataSet.array(_synthetic_corpus(B * BATCHES, S, V))
              >> JaxSampleToBatch(B))
        opt = JaxOptimizer(model, ds, jnn.FusedLMHeadCriterion()) \
            .set_optim_method(JaxAdamW(**ADAMW))
        trace, logger = jax_tracing, logging.getLogger("bigdl_tpu.optim")
    else:
        ds = (DataSet.array(synthetic_corpus(B * BATCHES, S, V))
              >> SampleToBatch(B))
        opt = Optimizer(model, ds, FusedLMHeadCriterion(), device="cpu") \
            .set_optim_method(AdamW(**ADAMW))
        trace, logger = tracing, None
    ds.shuffle = lambda: None
    opt.set_end_when(trigger).set_steps_per_dispatch(k)
    lines, level = _LossLines(), None
    if logger is not None:
        level = logger.level
        logger.addHandler(lines)
        logger.setLevel(logging.INFO)
    trace.clear()
    trace.enable()
    try:
        opt.optimize()
        windows = [e["args"]["k"] for e in trace.events()
                   if e["name"] == "train.dispatch"]
    finally:
        trace.disable()
        trace.clear()
        if logger is not None:
            logger.removeHandler(lines)
            logger.setLevel(level)
    losses = lines.losses if logger is not None else [
        h["loss"] for h in opt.history]
    return {"windows": windows, "losses": losses}


def run_both(k, end, port_end=None):
    """Both packages from the same weights with ``set_steps_per_dispatch(k)``
    until the end trigger that ``end(trigger_class)`` builds (``port_end``
    for the port, where it differs); per package its windows, losses and
    final weights."""
    manual_seed(11)
    jmodel = jax_transformer.build_lm(V, **CFG)
    tmodel = build_lm(V, **CFG, device="cpu", seed=0)
    import_lm_state_dict(tmodel, jax_export(jmodel))
    out = {"ref": _train("ref", jmodel, k, end(JaxTrigger)),
           "port": _train("port", tmodel, k, (port_end or end)(Trigger))}
    out["ref"]["weights"] = jax_export(jmodel)
    out["port"]["weights"] = export_lm_state_dict(tmodel)
    return out


def _trained(k):
    """The max_iteration run with k, computed once per k."""
    if k not in _CACHE:
        _CACHE[k] = run_both(k, lambda T: T.max_iteration(STEPS))
    return _CACHE[k]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_losses_and_weights_match_reference(k):
    res = _trained(k)
    ref, got = res["ref"], res["port"]
    assert len(ref["losses"]) == len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                               atol=LOSS_TOL)
    assert sorted(ref["weights"]) == sorted(got["weights"])
    for name in ref["weights"]:
        np.testing.assert_allclose(got["weights"][name], ref["weights"][name],
                                   **WEIGHT_TOL, err_msg=name)


@pytest.mark.parametrize("k", [2, 4])
def test_port_windows_change_no_number_on_cpu(k):
    one, many = _trained(1)["port"], _trained(k)["port"]
    assert many["losses"] == one["losses"]
    for name, w in one["weights"].items():
        np.testing.assert_array_equal(many["weights"][name], w, err_msg=name)


@pytest.mark.parametrize("k, want", [(1, [1] * STEPS), (2, [2, 1, 2, 1, 1]),
                                     (4, [3, 3, 1])])
def test_windows_end_at_epochs_and_at_max_iteration(k, want):
    res = _trained(k)
    assert res["ref"]["windows"] == res["port"]["windows"] == want


def test_probe_safety_of_the_factories_matches_reference():
    for T in (Trigger, JaxTrigger):
        assert T(lambda s: False).probe_safe is False
    for name, args in (("every_epoch", ()), ("several_iteration", (3,)),
                       ("max_epoch", (2,)), ("max_iteration", (5,)),
                       ("max_score", (0.5,)), ("min_loss", (0.1,))):
        got = getattr(Trigger, name)(*args)
        ref = getattr(JaxTrigger, name)(*args)
        assert (got.probe_safe, got.uses_loss) == (ref.probe_safe,
                                                   ref.uses_loss), name
    for comb in ("and_", "or_"):
        for parts in ((Trigger.max_epoch(1), Trigger.max_iteration(2)),
                      (Trigger.max_epoch(1), Trigger(lambda s: True))):
            assert getattr(Trigger, comb)(*parts).probe_safe == all(
                p.probe_safe for p in parts)


@pytest.mark.parametrize("k", [0, -1])
def test_k_below_one_raises(k):
    model = build_lm(V, **CFG, device="cpu", seed=0)
    ds = DataSet.array(synthetic_corpus(B, S, V)) >> SampleToBatch(B)
    opt = Optimizer(model, ds, FusedLMHeadCriterion(), device="cpu")
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        opt.set_steps_per_dispatch(k)


@pytest.mark.parametrize("make", [
    lambda: SGD(learningrate=0.1, momentum=0.9, weightdecay=1e-4,
                learningrate_schedule=Poly(0.5, 10)),
    lambda: Adagrad(learningrate=0.1, learningrate_decay=0.01),
    lambda: Adam(learningrate=1e-2, learningrate_decay=0.1),
    lambda: AdamW(**ADAMW)], ids=["sgd", "adagrad", "adam", "adamw"])
def test_update_from_step_scalars_tracks_the_float_update(make):
    """What a captured window's update reads (``step_scalars`` as a tensor)
    against the Python-float update: the same values in the same places
    (on the card the two agree to the bit, which ``chip_smoke.py`` phase 3f
    checks; the CPU divides where CUDA multiplies by a reciprocal, so here
    within float32 rounding)."""
    method = make()
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    pa, pb = {"w": w.clone()}, {"w": w.clone()}
    sa, sb = method.init_state(pa), method.init_state(pb)
    for _ in range(5):
        g = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
        row = torch.tensor(method.step_scalars(sb), dtype=torch.float32)
        method.update({"w": g.clone()}, sa, pa)
        method.update({"w": g.clone()}, sb, pb, row)
    assert sa["evalCounter"] == sb["evalCounter"] == 5
    torch.testing.assert_close(pb["w"], pa["w"], rtol=1e-6, atol=1e-7)
