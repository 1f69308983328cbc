"""The port's chaos injectors (``bigdl_tpu_torch/resilience/chaos.py``)
against the reference's, on the CPU: the ``BIGDL_CHAOS`` spec grammar
(every kind, every error) and each injector's firing rule."""

import signal

import numpy as np
import pytest
import torch

from bigdl_tpu.resilience import chaos as jchaos
from bigdl_tpu_torch.resilience import chaos as pchaos
from bigdl_tpu_torch.resilience import coordinator
from bigdl_tpu_torch.resilience.__main__ import main as resilience_main
from bigdl_tpu_torch.resilience.preemption import (PreemptionHandler,
                                                   _parse_signals)
from bigdl_tpu_torch.utils import file_io

torch.set_num_threads(1)

SPECS = ["kill@5", "kill@7:SIGINT", "kill@2:INT", "delay@3:0.25", "delay@4",
         "kill-replica@2", "delay-decode@3:0.25", "delay-decode@1",
         "drop-handoff@1", " drop-handoff@3 "]
BAD = ["kill", "kill@x", "frob@1", "kill@0", "delay@0:1", "kill-replica@0",
       "delay-decode@0", "drop-handoff@0", "delay@2:abc", "kill@1:SIGNOPE"]


def _describe(inj):
    return (type(inj).__name__, repr(inj))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_reference(spec):
    assert _describe(pchaos.parse_spec(spec)) == _describe(
        jchaos.parse_spec(spec))


def _error(fn, arg):
    try:
        fn(arg)
    except Exception as e:  # the type and message are compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("spec", BAD)
def test_parse_spec_errors_match_reference(spec):
    got = _error(pchaos.parse_spec, spec)
    assert got is not None and got == _error(jchaos.parse_spec, spec)


@pytest.mark.parametrize("value", ["", "  ", "kill@5,delay@3:0.5",
                                   "kill-replica@2, drop-handoff@1,",
                                   "delay-decode@2:0.1,kill@9:SIGINT"])
def test_from_env_matches_reference(monkeypatch, value):
    monkeypatch.setenv("BIGDL_CHAOS", value)
    assert ([_describe(i) for i in pchaos.from_env()]
            == [_describe(i) for i in jchaos.from_env()])


class _Server:
    requests_admitted = 0
    decode_blocks = 0


def test_kill_replica_fires_once_after_n_admissions():
    srv, inj = _Server(), pchaos.KillReplicaAfterRequests(2)
    inj.on_decode_block(srv)
    srv.requests_admitted = 1
    inj.on_decode_block(srv)
    assert not inj.fired
    srv.requests_admitted = 2
    with pytest.raises(pchaos.ChaosReplicaKill, match="after 2 admissions"):
        inj.on_decode_block(srv)
    srv.requests_admitted = 5
    inj.on_decode_block(srv)    # once only
    assert inj.fired
    assert issubclass(pchaos.ChaosReplicaKill, RuntimeError)


def test_delay_decode_sleeps_once_at_its_block():
    slept, srv = [], _Server()
    inj = pchaos.DelayDecodeStep(3, 0.125, _sleep=slept.append)
    for block in range(1, 7):
        srv.decode_blocks = block
        inj.on_decode_block(srv)
    assert slept == [0.125]


def test_drop_handoff_drops_exactly_the_nth():
    inj = pchaos.DropHandoff(2)
    assert [inj.on_handoff(None) for _ in range(5)] == [False, True, False,
                                                        False, False]


def test_training_injectors_fire_once():
    fired, slept = [], []
    kill = pchaos.KillAtStep(3, sig=0, _kill=lambda pid, sig: fired.append(
        sig))
    delay = pchaos.DelayAtStep(2, 0.5, _sleep=slept.append)
    for step in range(1, 6):
        kill.on_step(step)
        delay.on_step(step)
    assert fired == [0] and slept == [0.5]


@pytest.mark.parametrize("cls, args", [
    (pchaos.KillAtStep, (0,)), (pchaos.DelayAtStep, (0, 1.0)),
    (pchaos.KillReplicaAfterRequests, (0,)), (pchaos.DelayDecodeStep, (0, 1)),
    (pchaos.DropHandoff, (0,))])
def test_injectors_reject_a_step_below_one(cls, args):
    with pytest.raises(ValueError, match=">= 1"):
        cls(*args)


def test_preemption_handler_trigger_and_signal_parsing(monkeypatch):
    assert _parse_signals("TERM, SIGINT,") == (signal.SIGTERM,
                                               signal.SIGINT)
    monkeypatch.setenv("BIGDL_PREEMPT_SIGNALS", "SIGUSR1")
    h = PreemptionHandler(grace_seconds=5)
    assert h.signals == (signal.SIGUSR1,)
    assert not h.should_snapshot() and h.remaining_grace() == float("inf")
    h.trigger("drill")
    h.trigger("second")          # the first notice's reason stays
    assert h.should_snapshot() and h.reason == "drill"
    assert h.drain_notices() == 1 and h.drain_notices() == 0


def test_selftest_cli_and_waiting_commands(capsys, tmp_path):
    assert resilience_main(["chaos", "selftest"]) == 0
    assert "spec parsing ok" in capsys.readouterr().out
    # validate, latest and corrupt on a snapshot pair written here
    for tag in (3, 6):
        file_io.save({"params": {"w": np.full(4, tag, np.float32)},
                      "buffers": {}}, str(tmp_path / f"model.{tag}"))
        files = {"model": coordinator._digest(str(tmp_path / f"model.{tag}"))}
        file_io.save({"optim": {"evalCounter": tag}, "driver": {}},
                     str(tmp_path / f"state.{tag}"))
        files["state"] = coordinator._digest(str(tmp_path / f"state.{tag}"))
        coordinator.write_marker(
            str(tmp_path / f"state.{tag}"), step=tag, epoch=1, rng=None,
            epoch_batches=tag - 1, epoch_records=0,
            mesh=coordinator.current_mesh_descriptor(), files=files)
    capsys.readouterr()
    assert resilience_main(["validate", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == ["complete", "complete"]
    assert resilience_main(["chaos", "corrupt", str(tmp_path / "model.6"),
                            "--seed", "3"]) == 0
    assert "(flip)" in capsys.readouterr().out
    assert resilience_main(["validate", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("PARTIAL") and "model.6" in out[0]
    assert resilience_main(["latest", str(tmp_path)]) == 0
    assert capsys.readouterr().out.split() == [str(tmp_path / "model.3"),
                                                str(tmp_path / "state.3")]
