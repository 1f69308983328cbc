"""Checkpoint, resume, validation and preemption in the port's training loop
(``bigdl_tpu_torch/optim/optimizer.py``, ``resilience/coordinator.py``),
the counterpart of ``tests/test_resilience.py``, on the CPU.

- A real SIGTERM (``KillAtStep``) mid-epoch, one final snapshot, and an
  ``auto_resume`` from a model built from another seed: the result is
  BIT-EQUAL to the uninterrupted run (dropout masks, shuffled data and
  the optim state's host counter included), at k = 1 and under
  ``set_steps_per_dispatch(2)``, whose windows stop at the checkpoint
  trigger and at the kill. The marker's step, epoch and cursor equal the
  reference's for the same schedule.
- Partial snapshots are skipped; preemption without a checkpoint path
  stops cleanly; the SIGTERM handlers are restored; the in-process retry
  restarts from the newest snapshot; ``Trigger.max_score`` stops on the
  validation score.
- Cross-package: the reference's uninterrupted tiny-LM run (the Llama
  recipe, weights carried across) against the port's, killed at step 5
  and resumed: per-step losses within ``LOSS_TOL`` and final weights
  within ``WEIGHT_TOL`` of ``test_torch_lm_train.py``, and the validation
  results at every trigger within 1e-5 relative.
"""

import logging
import os
import signal

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.apps.transformer import _synthetic_corpus
from bigdl_tpu.dataset.base import DataSet as JaxDataSet
from bigdl_tpu.dataset.base import MiniBatch as JaxMiniBatch
from bigdl_tpu.dataset.base import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.optim import AdamW as JaxAdamW
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import Optimizer as JaxOptimizer
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import Trigger as JaxTrigger
from bigdl_tpu.optim import validation as jv
from bigdl_tpu.resilience import KillAtStep as JaxKillAtStep
from bigdl_tpu.resilience import PreemptionHandler as JaxPreemptionHandler
from bigdl_tpu.resilience import TrainingPreempted as JaxTrainingPreempted
from bigdl_tpu.resilience import coordinator as jax_coordinator
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.apps.transformer import synthetic_corpus
from bigdl_tpu_torch.dataset.base import (AbstractDataSet, DataSet, MiniBatch,
                                          SampleToBatch)
from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                import_lm_state_dict)
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.optim import (SGD, AdamW, Loss, Optimizer, Perplexity,
                                   Top1Accuracy, Trigger)
from bigdl_tpu_torch.resilience import (KillAtStep, PreemptionHandler,
                                        TrainingPreempted, coordinator,
                                        corrupt_snapshot)
from bigdl_tpu_torch.telemetry import get_registry, instruments, tracing

LOSS_TOL = 1e-4                               # test_torch_lm_train.py's
WEIGHT_TOL = dict(rtol=1e-3, atol=1e-4)       # test_torch_lm_train.py's
VALIDATION_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fixed_batches(n_batches=4, batch=16, dim=6, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, dim).astype(np.float32),
             rng.randint(1, classes + 1, batch).astype(np.float32))
            for _ in range(n_batches)]


class _FixedDataSet(AbstractDataSet):
    """The reference test's dataset: the same batches every epoch."""

    def __init__(self, batches, mini=MiniBatch):
        self.batches, self.mini = batches, mini

    def data(self, train):
        for x, y in self.batches:
            yield self.mini(x, y)

    def size(self):
        return sum(b[0].shape[0] for b in self.batches)

    def shuffle(self):
        pass


def _shuffled():
    """4 batches of 16 from a seeded dataset whose every epoch reshuffles:
    a resume must replay the shuffles to see the same data."""
    from bigdl_tpu_torch.dataset.base import Sample
    rng = np.random.RandomState(1)
    samples = [Sample(rng.randn(6).astype(np.float32),
                      np.float32(rng.randint(1, 4))) for _ in range(64)]
    return DataSet.array(samples, seed=3) >> SampleToBatch(16)


def _mk_model(seed=11, dropout=0.3):
    torch.manual_seed(seed)
    m = nn.Sequential().add(nn.Linear(6, 8)).add(nn.ReLU())
    if dropout:
        m.add(nn.Dropout(dropout))   # makes the generators load-bearing
    return m.add(nn.Linear(8, 3)).add(nn.LogSoftMax())


def _optimizer(ds, ckpt=None, trigger=None, k=1, model=None, dropout=0.3):
    opt = Optimizer(model or _mk_model(dropout=dropout), ds,
                    nn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_epoch(3)).set_steps_per_dispatch(k)
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), trigger or Trigger.every_epoch())
    return opt


def _flat(model):
    return torch.cat([p.detach().flatten() for p in model.parameters()])


def _windows(fn):
    tracing.clear()
    tracing.enable()
    try:
        fn()
        return [e["args"]["k"] for e in tracing.events()
                if e["name"] == "train.dispatch"]
    finally:
        tracing.disable()
        tracing.clear()


def _reference_marker(tmp_path):
    """The reference's marker for a kill at step 6 of the same schedule."""
    manual_seed(7)
    jm = (jnn.Sequential().add(jnn.Linear(6, 8)).add(jnn.Tanh())
          .add(jnn.Dropout(0.3)).add(jnn.Linear(8, 3)).add(jnn.LogSoftMax()))
    opt = JaxOptimizer(jm, _FixedDataSet(_fixed_batches(), JaxMiniBatch),
                       jnn.ClassNLLCriterion())
    opt.set_optim_method(JaxSGD(learningrate=0.1, momentum=0.9))
    opt.set_end_when(JaxTrigger.max_epoch(3))
    opt.set_checkpoint(str(tmp_path), JaxTrigger.every_epoch())
    opt.set_preemption_handler(JaxPreemptionHandler(
        signals=(signal.SIGTERM,)))
    opt.set_chaos([JaxKillAtStep(6)])
    with pytest.raises(JaxTrainingPreempted):
        opt.optimize()
    return jax_coordinator.latest_resume_point(str(tmp_path)).marker


@pytest.mark.parametrize("data", ["fixed", "shuffled"])
@pytest.mark.parametrize("k", [1, 2])
def test_kill_midepoch_then_resume_is_bit_equal(tmp_path, k, data):
    def dataset():
        return (_FixedDataSet(_fixed_batches()) if data == "fixed"
                else _shuffled())

    # k = 2 bounds its windows by a checkpoint every 3 iterations
    trigger = Trigger.every_epoch() if k == 1 else \
        Trigger.several_iteration(3)
    ref_opt = _optimizer(dataset(), k=k)
    ref = _flat(ref_opt.optimize())
    ref_losses = [h["loss"] for h in ref_opt.history]

    ckpt = tmp_path / "ck"
    opt = _optimizer(dataset(), ckpt, trigger, k)
    opt.set_preemption_handler(PreemptionHandler(signals=(signal.SIGTERM,)))
    opt.set_chaos([KillAtStep(6)])
    with pytest.raises(TrainingPreempted) as e:
        opt.optimize()
    assert e.value.snapshot == str(ckpt / "model.7")
    point = coordinator.latest_resume_point(str(ckpt))
    assert point.neval == 7 and point.marker["step"] == 7
    assert point.marker["cursor"] == {"epoch": 2, "epoch_batches": 2,
                                      "epoch_records": 32}

    opt2 = _optimizer(dataset(), ckpt, trigger, k,
                      model=_mk_model(seed=99)).auto_resume()
    windows = _windows(opt2.optimize)
    assert torch.equal(_flat(opt2.model), ref)
    losses = [h["loss"] for h in opt.history + opt2.history]
    assert losses == ref_losses
    assert [h["neval"] for h in opt2.history] == list(range(7, 13))
    if k == 2:
        # epoch 2 from its third batch: [7, 8]; epoch 3 stops before the
        # checkpoint at 12 fires inside a window: [9, 10], [11], [12]
        assert windows == [2, 2, 1, 1]


def test_windows_stop_at_checkpoints_and_at_the_kill(tmp_path):
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path,
                     Trigger.several_iteration(3), k=2)
    opt.set_preemption_handler(PreemptionHandler(signals=(signal.SIGTERM,)))
    opt.set_chaos([KillAtStep(6)])
    windows = _windows(lambda: pytest.raises(TrainingPreempted,
                                             opt.optimize))
    # [1, 2] [3, 4]; 6 is a checkpoint neval: [5]; the kill after 6: [6]
    assert windows == [2, 2, 1, 1]
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if n.startswith("model")] == [
        "model.3", "model.6", "model.7"]


def test_marker_matches_the_reference(tmp_path):
    want = _reference_marker(tmp_path / "ref")
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path / "port")
    opt.set_preemption_handler(PreemptionHandler(signals=(signal.SIGTERM,)))
    opt.set_chaos([KillAtStep(6)])
    with pytest.raises(TrainingPreempted):
        opt.optimize()
    got = coordinator.latest_resume_point(str(tmp_path / "port")).marker
    for key in ("format", "step", "epoch", "cursor"):
        assert got[key] == want[key], key
    assert got["mesh"]["process_count"] == 1
    assert len(got["rng"]["dropout"]) == 1 and got["files"]["model"]


def test_hooks_do_not_change_training(tmp_path):
    plain = _optimizer(_FixedDataSet(_fixed_batches()))
    plain.optimize()
    hooked = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path,
                        Trigger.several_iteration(2))
    hooked.set_validation(Trigger.several_iteration(3),
                          _FixedDataSet(_fixed_batches(2, seed=5)),
                          [Top1Accuracy(), Loss()])
    hooked.optimize()
    assert torch.equal(_flat(plain.model), _flat(hooked.model))
    assert [h["loss"] for h in plain.history] == \
        [h["loss"] for h in hooked.history]
    # nevals 3, 6, 9 and 12; the epoch-end hook sees neval 9 once more
    # (8 = 2 x 4 batches), as the reference's does
    assert [v["neval"] for v in hooked.validation_history] == [3, 6, 9, 9,
                                                               12]
    assert all(v["results"]["Top1Accuracy"].count == 32
               for v in hooked.validation_history)


def test_snapshot_holds_params_buffers_optim_and_driver(tmp_path):
    from bigdl_tpu_torch.utils import file_io
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path)
    opt.optimize()
    params, optim, driver = coordinator.load_snapshot_host(
        str(tmp_path / "model.9"), str(tmp_path / "state.9"))
    assert optim["evalCounter"] == 8 and driver["neval"] == 9
    assert sorted(params) == sorted(optim["velocity"])
    snap = file_io.load(str(tmp_path / "model.5"))
    state = file_io.load(str(tmp_path / "state.5"))
    assert sorted(snap) == ["buffers", "params"]
    assert sorted(snap["params"]) == sorted(
        n for n, _ in opt.model.named_parameters())
    assert all(isinstance(v, np.ndarray) for v in snap["params"].values())
    assert state["optim"]["evalCounter"] == 4
    assert state["driver"]["neval"] == 5 and state["driver"]["epoch"] == 2
    # the checkpoint hook flushed first: the driver's loss is step 4's
    assert state["driver"]["trainingLoss"] == opt.history[3]["loss"]


def test_partial_snapshot_rejected_previous_used(tmp_path):
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path)
    opt.optimize()
    pairs = [p[2] for p in coordinator.snapshot_pairs(str(tmp_path))]
    assert pairs == ["model.5", "model.9", "model.13"]
    assert coordinator.latest_resume_point(str(tmp_path)).neval == 13
    corrupt_snapshot(str(tmp_path / "model.13"), mode="flip", seed=3)
    assert not coordinator.validate_pair(str(tmp_path / "model.13"),
                                         str(tmp_path / "state.13"))
    assert coordinator.latest_resume_point(str(tmp_path)).neval == 9
    corrupt_snapshot(str(tmp_path / "state.9"), mode="truncate")
    assert coordinator.latest_resume_point(str(tmp_path)).neval == 5


def test_corrupt_is_deterministic(tmp_path):
    for name in ("a", "b"):
        (tmp_path / name).write_bytes(bytes(range(256)) * 8)
    ia = corrupt_snapshot(str(tmp_path / "a"), seed=7)
    ib = corrupt_snapshot(str(tmp_path / "b"), seed=7)
    assert ia["positions"] == ib["positions"]
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    with pytest.raises(ValueError, match="unknown mode"):
        corrupt_snapshot(str(tmp_path / "a"), mode="shred")


def test_plain_pair_requires_nonempty_files(tmp_path):
    (tmp_path / "model.2").write_bytes(b"x" * 10)
    (tmp_path / "state.2").write_bytes(b"")  # truncated by a kill
    assert coordinator.latest_resume_point(str(tmp_path)) is None
    (tmp_path / "state.2").write_bytes(b"y" * 10)
    assert coordinator.latest_resume_point(str(tmp_path)).neval == 2


def test_sharded_snapshots_wait(tmp_path):
    """Sharded snapshots work now (the name is kept from when they waited
    for their port): empty directories are skipped as incomplete, and a
    real sharded pair resumes bit-equal; a damaged one is refused."""
    (tmp_path / "model.4").mkdir()
    (tmp_path / "state.4").mkdir()
    assert coordinator.latest_resume_point(str(tmp_path)) is None
    ref = _flat(_optimizer(_FixedDataSet(_fixed_batches())).optimize())
    opt = _optimizer(_FixedDataSet(_fixed_batches()))
    opt.set_checkpoint(str(tmp_path), Trigger.several_iteration(6),
                       sharded=True)
    opt.optimize()
    point = coordinator.latest_resume_point(str(tmp_path))
    assert point.neval == 12 and point.sharded
    opt2 = _optimizer(_FixedDataSet(_fixed_batches()),
                      model=_mk_model(seed=99))
    opt2.set_checkpoint(str(tmp_path), Trigger.several_iteration(6),
                        sharded=True)
    opt2.resume(str(tmp_path / "model.6"), str(tmp_path / "state.6"))
    opt2.optimize()
    assert [h["neval"] for h in opt2.history] == list(range(6, 13))
    assert torch.equal(_flat(opt2.model), ref)
    corrupt_snapshot(str(tmp_path / "model.12"), mode="delete")
    assert coordinator.latest_resume_point(str(tmp_path)).neval == 6
    assert coordinator.is_elastic({"mesh": {"process_count": 2}}) is True
    assert coordinator.is_elastic({"mesh": {"process_count": 1}}) is False
    assert coordinator.is_elastic(None) is None


def test_preemption_without_checkpoint_path_stops_cleanly():
    opt = _optimizer(_FixedDataSet(_fixed_batches()))
    opt.set_preemption_handler(PreemptionHandler(signals=(signal.SIGTERM,)))
    opt.set_chaos([KillAtStep(2)])
    with pytest.raises(TrainingPreempted) as e:
        opt.optimize()
    assert e.value.snapshot is None
    assert [h["neval"] for h in opt.history] == [1, 2]


def test_sigterm_handlers_removed_after_preemption(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path)
    opt.set_preemption_handler(PreemptionHandler(signals=(signal.SIGTERM,)))
    opt.set_chaos([KillAtStep(3)])
    with pytest.raises(TrainingPreempted):
        opt.optimize()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_chaos_from_env_and_resilience_series(tmp_path, monkeypatch):
    tm = instruments(get_registry())
    pre0 = tm.resilience_preemptions_total.labels().value
    snaps0 = tm.resilience_snapshot_seconds.labels().count or 0
    res0 = tm.resilience_resumes_total.labels(elastic="false").value
    monkeypatch.setenv("BIGDL_CHAOS", "kill@2")
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path)
    opt.set_preemption_handler(PreemptionHandler(signals=(signal.SIGTERM,)))
    with pytest.raises(TrainingPreempted):
        opt.optimize()
    monkeypatch.delenv("BIGDL_CHAOS")
    assert tm.resilience_preemptions_total.labels().value == pre0 + 1
    assert tm.resilience_snapshot_seconds.labels().count == snaps0 + 1
    _optimizer(_FixedDataSet(_fixed_batches()), tmp_path) \
        .auto_resume().optimize()
    assert tm.resilience_resumes_total.labels(elastic="false").value \
        == res0 + 1


class _FailOnce:
    """Raises a RuntimeError after step ``step`` completes, once."""

    def __init__(self, step):
        self.step, self.fired = step, False

    def on_step(self, neval):
        if not self.fired and neval >= self.step:
            self.fired = True
            raise RuntimeError("injected step failure")


def test_in_process_retry_restarts_from_newest_snapshot(tmp_path, caplog):
    plain = _optimizer(_FixedDataSet(_fixed_batches()), dropout=0)
    ref = _flat(plain.optimize())
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path, dropout=0)
    opt.set_chaos([_FailOnce(6)])
    with caplog.at_level(logging.WARNING, logger="bigdl_tpu_torch.optim"):
        opt.optimize()
    assert any("[Retry 1/5]" in m and "model.5" in m
               for m in caplog.messages)
    # the failed attempt's steps whose losses were fetched (step 6's was
    # still in flight), then epoch 2 again from its first batch
    assert [h["neval"] for h in opt.history] == \
        list(range(1, 6)) + list(range(5, 13))
    assert torch.equal(_flat(opt.model), ref)


def test_retry_gives_up_without_a_snapshot_or_past_its_budget(
        tmp_path, monkeypatch):
    opt = _optimizer(_FixedDataSet(_fixed_batches()))
    opt.set_chaos([_FailOnce(2)])
    with pytest.raises(RuntimeError, match="injected"):
        opt.optimize()
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_TIMES", "0")
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path)
    opt.set_chaos([_FailOnce(6)])
    with pytest.raises(RuntimeError, match="injected"):
        opt.optimize()


def test_configuration_errors_are_not_retried(tmp_path):
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path)
    opt.optimize()
    opt2 = Optimizer(_mk_model(), _FixedDataSet(_fixed_batches()),
                     nn.ClassNLLCriterion(), device="cpu")
    opt2.set_optim_method(AdamW()).set_end_when(Trigger.max_epoch(4))
    opt2.set_checkpoint(str(tmp_path), Trigger.every_epoch()).auto_resume()
    with pytest.raises(ValueError, match="another optim method"):
        opt2.optimize()


def test_max_score_stops_on_the_validation_score():
    val = _FixedDataSet(_fixed_batches(2, seed=5))
    for threshold, steps in ((-1.0, 2), (2.0, 12)):
        opt = _optimizer(_FixedDataSet(_fixed_batches()))
        opt.set_validation(Trigger.several_iteration(3), val,
                           [Top1Accuracy(), Loss()])
        opt.set_end_when(Trigger.or_(Trigger.max_score(threshold),
                                     Trigger.max_epoch(3)))
        opt.optimize()
        assert len(opt.history) == steps
        first = opt.validation_history[0]["results"]["Top1Accuracy"]
        assert 0.0 <= first.result()[0] <= 1.0


def test_overwrite_and_set_state(tmp_path):
    opt = _optimizer(_FixedDataSet(_fixed_batches()), tmp_path)
    opt.overwrite_checkpoint().set_state({"epoch": 2, "neval": 5})
    opt.optimize()
    assert sorted(n for n in os.listdir(tmp_path)
                  if not n.endswith(".json")) == ["model", "state"]
    assert [h["neval"] for h in opt.history] == list(range(5, 13))
    point = coordinator.latest_resume_point(str(tmp_path))
    assert point.neval == -1 and point.marker["step"] == 13


# --------------------------------------------------------- cross-package LM
V, B, S = 96, 4, 16
LLAMA = dict(embed_dim=32, num_heads=4, num_kv_heads=2, ffn_dim=64,
             num_layers=2, max_len=32, rope=True, activation="swiglu",
             norm="rms", bias=False, tie_embeddings=True)
GPT = dict(embed_dim=32, num_heads=4, ffn_dim=64, num_layers=2, max_len=32,
           fused_head=True)
CONFIGS = {"llama": LLAMA, "gpt": GPT}   # test_torch_lm_train.py's
ADAMW = dict(learningrate=3e-3, weightdecay=0.01)
STEPS, KILL = 12, 5


def _reference_lm_run(jmodel, val_samples, monkeypatch, caplog):
    import re
    ds = JaxDataSet.array(_synthetic_corpus(4 * B, S, V)) >> \
        JaxSampleToBatch(B)
    ds.shuffle = lambda: None
    val = JaxDataSet.array(val_samples) >> JaxSampleToBatch(B)
    opt = (JaxOptimizer(jmodel, ds, jnn.FusedLMHeadCriterion())
           .set_optim_method(JaxAdamW(**ADAMW))
           .set_end_when(JaxTrigger.max_iteration(STEPS))
           .set_validation(JaxTrigger.several_iteration(4), val, [
               jv.Loss(jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())),
               jv.Perplexity()]))
    seen = []
    run = JaxLocalOptimizer._run_validation

    def recording(self, *a, **k):
        results, count = run(self, *a, **k)
        seen.append([r.state() for r in results])
        return results, count

    monkeypatch.setattr(JaxLocalOptimizer, "_run_validation", recording)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="bigdl_tpu.optim"):
        opt.optimize()
    pattern = re.compile(r"Loss is (-?[0-9.]+)\.")
    losses = [float(m.group(1)) for m in map(pattern.search,
                                             caplog.messages) if m]
    return losses, seen


def _port_lm_optimizer(tmodel, val_samples, ckpt):
    ds = DataSet.array(synthetic_corpus(4 * B, S, V)) >> SampleToBatch(B)
    ds.shuffle = lambda: None
    val = DataSet.array(val_samples) >> SampleToBatch(B)
    return (Optimizer(tmodel, ds, nn.FusedLMHeadCriterion(), device="cpu")
            .set_optim_method(AdamW(**ADAMW))
            .set_end_when(Trigger.max_iteration(STEPS))
            .set_checkpoint(str(ckpt), Trigger.every_epoch())
            .set_validation(Trigger.several_iteration(4), val, [
                Loss(nn.TimeDistributedCriterion(nn.ClassNLLCriterion())),
                Perplexity()]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_killed_and_resumed_lm_matches_uninterrupted_reference(
        tmp_path, monkeypatch, caplog, name):
    """Validation is compared on each result's mergeable state (the loss
    and NLL sums, and the counts): a perplexity is exp of the mean NLL, so
    its relative difference is the NLL's ABSOLUTE one, which the tied
    model's N(0, 1) embedding init puts near a mean NLL of 23."""
    manual_seed(11)
    jmodel = jax_transformer.build_lm(V, **CONFIGS[name])
    tmodel = build_lm(V, **CONFIGS[name], device="cpu", seed=0)
    import_lm_state_dict(tmodel, jax_export(jmodel))
    val_samples = synthetic_corpus(2 * B, S, V, seed=23)

    ref_losses, ref_val = _reference_lm_run(jmodel, val_samples,
                                            monkeypatch, caplog)

    opt = _port_lm_optimizer(tmodel, val_samples, tmp_path)
    opt.set_preemption_handler(PreemptionHandler(signals=(signal.SIGTERM,)))
    opt.set_chaos([KillAtStep(KILL)])
    with pytest.raises(TrainingPreempted):
        opt.optimize()
    point = coordinator.latest_resume_point(str(tmp_path))
    assert point.marker["step"] == KILL + 1
    assert point.marker["cursor"] == {"epoch": 2, "epoch_batches": 1,
                                      "epoch_records": B}

    fresh = build_lm(V, **CONFIGS[name], device="cpu", seed=42)
    opt2 = _port_lm_optimizer(fresh, val_samples, tmp_path).auto_resume()
    opt2.optimize()

    losses = [h["loss"] for h in opt.history + opt2.history]
    assert len(losses) == len(ref_losses) == STEPS
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=LOSS_TOL)
    ref_w, got_w = jax_export(jmodel), export_lm_state_dict(fresh)
    assert sorted(ref_w) == sorted(got_w)
    e = CONFIGS[name]["embed_dim"]
    for k in ref_w:
        if k.endswith("in_proj_bias"):
            # the key bias's exact gradient is 0: roundoff that Adam's
            # normalised step moves by up to lr a step, held to that bound
            # as test_torch_lm_train.py holds it
            kb = slice(e, 2 * e)
            assert np.abs(got_w[k][kb] - ref_w[k][kb]).max() <= (
                2 * ADAMW["learningrate"] * STEPS)
            got_w[k][kb] = ref_w[k][kb]
        np.testing.assert_allclose(got_w[k], ref_w[k], **WEIGHT_TOL,
                                   err_msg=k)
    vals = opt.validation_history + opt2.validation_history
    assert [v["neval"] for v in vals] == [4, 8, 12]
    got_val = [[r.state() for r in v["results"].values()] for v in vals]
    assert len(ref_val) == 3
    np.testing.assert_allclose(got_val, ref_val, rtol=VALIDATION_RTOL)
    # Perplexity is exp of the mean token NLL that Loss reports
    for v in vals:
        loss, ppl = (r.result()[0] for r in v["results"].values())
        np.testing.assert_allclose(ppl, np.exp(loss), rtol=1e-6)
