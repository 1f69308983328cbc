"""The port's ``LMRouter`` (``bigdl_tpu_torch/models/router.py``) and the
drain lifecycle of its ``ContinuousLMServer``, on the CPU.

The reference's ``tests/test_serving_fleet.py`` ``TestRouterUnits`` and
``TestDrainLifecycle`` cases, mirrored: router units against duck-typed
stub replicas (least-loaded dispatch, round-robin ties, bounded retry,
requeue with the cursor, per-replica health, drain and close fan-out), and
drains of live servers whose weights come from the reference's fleet model
(``_mk_model``), the stitched output held to the reference's greedy
``generate`` token for token.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.models.generation import generate as jax_generate
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.interop.state_dict import import_lm_state_dict
from bigdl_tpu_torch.models.router import LMRouter, Replica
from bigdl_tpu_torch.models.serving import (ContinuousLMServer,
                                            HandoffCursor,
                                            ReplicaUnavailable, ServerDead,
                                            ServerDraining)
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.telemetry import MetricsRegistry, instruments

torch.set_num_threads(1)

VOCAB = 24
FLEET_LM = dict(embed_dim=16, num_heads=2, ffn_dim=32, num_layers=2,
                max_len=64, rope=True, activation="swiglu", norm="rms",
                tie_embeddings=True)
_REF = {}


def _jax_model():
    """The reference fleet tests' ``_mk_model`` (seed 4)."""
    if "jax" not in _REF:
        manual_seed(4)
        _REF["jax"] = jax_transformer.build_lm(VOCAB, **FLEET_LM)
    return _REF["jax"]


def _mk_model():
    tm = build_lm(VOCAB, **FLEET_LM, device="cpu", seed=0)
    import_lm_state_dict(tm, jax_export(_jax_model()))
    return tm.evaluate_mode()


def _ref_continuation(ids, max_new):
    out = np.asarray(jax_generate(_jax_model(), jnp.asarray(
        np.asarray(ids, np.float32)[None]), max_new, greedy=True))
    return out[0, len(ids):].astype(int).tolist()


class _StubServer:
    """Duck-typed replica: records submits, scripted to fail."""

    def __init__(self, depth=0, fail=None, sticky=True):
        self.queue_depth = depth
        self.dead_reason = None
        self.drain_reason = None
        self.batches_served = 0
        self.submits = []
        self._fail = list(fail or [])
        self._sticky = sticky
        self.closed = 0
        self.drained = []

    def submit(self, ids, max_new=None, timeout=None, *, emitted=None,
               state=None):
        self.submits.append((list(ids), emitted, state))
        if self._fail:
            err = self._fail.pop(0)
            # a replica that raised draining/dead reports that state
            # (unless sticky=False), so the retry routes around it
            if self._sticky and isinstance(err, ServerDraining):
                self.drain_reason = str(err)
            elif self._sticky and isinstance(err, ServerDead):
                self.dead_reason = str(err)
            raise err
        return (emitted or []) + [7, 8]

    def drain(self, reason="x"):
        self.drained.append(reason)
        self.drain_reason = reason

    def close(self):
        self.closed += 1


class TestRouterUnits:
    def test_least_loaded_dispatch_skips_busy_and_unhealthy(self):
        idle, busy, dead = _StubServer(0), _StubServer(5), _StubServer(0)
        dead.dead_reason = "gone"
        router = LMRouter([busy, dead, idle], registry=MetricsRegistry())
        assert router.submit([1, 2], 2) == [7, 8]
        assert idle.submits and not busy.submits and not dead.submits

    def test_round_robin_tie_break_spreads_equal_replicas(self):
        a, b = _StubServer(), _StubServer()
        router = LMRouter([a, b], registry=MetricsRegistry())
        for _ in range(4):
            router.submit([1], 1)
        assert a.submits and b.submits

    def test_retry_moves_rejected_dispatch_to_peer(self):
        flaky = _StubServer(fail=[ServerDraining("draining: sigterm")])
        steady = _StubServer(depth=1)     # higher load: tried second
        reg = MetricsRegistry()
        router = LMRouter([flaky, steady], registry=reg, backoff_s=0.001)
        assert router.submit([1, 2], 2) == [7, 8]
        assert steady.submits == [([1, 2], None, None)]
        tm = instruments(reg)
        assert tm.router_retries_total.value == 1
        assert tm.router_requeues_total.value == 0
        assert tm.router_requests_total.value == 1

    def test_requeue_carries_the_cursor_progress(self):
        cursor = HandoffCursor(ids=[1, 2], emitted=[5, 9], max_new=4)
        flaky = _StubServer(fail=[ServerDead("died mid-flight",
                                             cursor=cursor)])
        steady = _StubServer(depth=1)
        reg = MetricsRegistry()
        router = LMRouter([flaky, steady], registry=reg, backoff_s=0.001)
        assert router.submit([1, 2], 4) == [5, 9, 7, 8]
        # the peer was asked to RESUME, not restart
        assert steady.submits == [([1, 2], [5, 9], None)]
        assert instruments(reg).router_requeues_total.value == 1

    def test_bounded_retries_then_raise(self):
        # sticky=False: the replica keeps claiming health while every
        # dispatch bounces; the retry ceiling stops the loop
        always = _StubServer(fail=[ServerDraining("no") for _ in range(9)],
                             sticky=False)
        router = LMRouter([always], registry=MetricsRegistry(),
                          max_retries=2, backoff_s=0.001)
        with pytest.raises(ReplicaUnavailable):
            router.submit([1], 1)
        assert len(always.submits) == 3   # initial + 2 retries

    def test_no_healthy_replica_raises_server_dead(self):
        a = _StubServer()
        a.dead_reason = "boom"
        router = LMRouter([a], registry=MetricsRegistry())
        with pytest.raises(ServerDead, match="no healthy replicas"):
            router.submit([1], 1)
        assert router.dead_reason is not None

    def test_health_surface_reports_per_replica_states(self):
        ok, draining = _StubServer(), _StubServer()
        draining.drain_reason = "sigterm"
        router = LMRouter([ok, draining], registry=MetricsRegistry())
        assert router.dead_reason is None  # one healthy replica suffices
        states = {r["name"]: r["state"]
                  for r in router.health_extra["replicas"]}
        assert states == {"decode-0": "ok", "decode-1": "draining"}

    def test_drain_and_close_fan_out_once_per_server(self):
        a, b = _StubServer(), _StubServer()
        router = LMRouter([a, b],
                          prefill_replicas=[Replica(a, role="prefill")],
                          registry=MetricsRegistry())
        router.drain("fleet sigterm")
        assert a.drained == ["fleet sigterm"] and b.drained
        router.close()
        assert a.closed == 1 and b.closed == 1   # a shared across roles

    def test_configuration_errors(self):
        with pytest.raises(ValueError, match="at least one"):
            LMRouter([], registry=MetricsRegistry())
        with pytest.raises(ValueError, match="max_retries"):
            LMRouter([_StubServer()], max_retries=-1,
                     registry=MetricsRegistry())
        with pytest.raises(ValueError, match="role"):
            Replica(_StubServer(), role="both")

    def test_dropped_handoff_is_reshipped_then_local_fallback(self):
        from bigdl_tpu_torch.resilience.chaos import DropHandoff

        class _Prefill(_StubServer):
            def prefill_handoff(self, ids, emitted=None):
                return b"blob"

        reg = MetricsRegistry()
        decode, pre = _StubServer(), _Prefill()
        router = LMRouter([decode], prefill_replicas=[pre], registry=reg,
                          chaos=[DropHandoff(1)], backoff_s=0.001)
        assert router.submit([1, 2], 2) == [7, 8]
        assert decode.submits == [([1, 2], None, b"blob")]
        tm = instruments(reg)
        assert tm.router_retries_total.value == 1
        assert tm.handoff_seconds.labels().snapshot()["count"] == 2
        pre.dead_reason = "gone"     # no healthy prefill replica: local
        assert router.submit([3], 2) == [7, 8]
        assert decode.submits[-1] == ([3], None, None)


class TestDrainLifecycle:
    def test_drain_is_distinct_from_dead_and_stops_admission(self):
        srv = ContinuousLMServer(_mk_model(), slots=2, max_len=32,
                                 greedy=True, decode_block=2, device="cpu",
                                 registry=MetricsRegistry())
        try:
            assert len(srv.submit([3, 7, 2], 3, timeout=120)) == 3
            srv.drain("sigterm drill")
            assert srv.drain_reason == "sigterm drill"
            assert srv.dead_reason is None
            t0 = time.perf_counter()
            with pytest.raises(ServerDraining, match="draining"):
                srv.submit([2, 2], 3, timeout=120)
            assert time.perf_counter() - t0 < 1.0   # fail-fast, no queue
        finally:
            srv.close()

    def test_drain_midflight_snapshots_cursor_and_peer_resumes(self):
        """Drain a server mid-generation, catch the cursor, resume
        prompt+emitted on a peer: the stitched output equals the
        reference's uninterrupted greedy generation."""
        reg = MetricsRegistry()
        a = ContinuousLMServer(_mk_model(), slots=1, max_len=48,
                               greedy=True, decode_block=1, device="cpu",
                               registry=reg)
        b = ContinuousLMServer(_mk_model(), slots=1, max_len=48,
                               greedy=True, decode_block=2, device="cpu",
                               registry=reg)
        ids, max_new = [3, 7, 2, 9], 10
        box = {}
        gate = threading.Event()

        def slow_step(inner=a._step):
            gate.wait(timeout=60)   # hold the first round until drained
            return inner()

        a._step = slow_step

        def client():
            try:
                a.submit(ids, max_new, timeout=120)
            except ServerDraining as e:
                box["cursor"] = e.cursor

        try:
            t = threading.Thread(target=client)
            t.start()
            deadline = time.time() + 60
            while a.requests_admitted < 1 and time.time() < deadline:
                time.sleep(0.01)
            drainer = threading.Thread(target=a.drain,
                                       args=("preemption notice",))
            drainer.start()
            time.sleep(0.05)
            gate.set()
            drainer.join(timeout=60)
            t.join(timeout=60)
            cur = box.get("cursor")
            assert cur is not None and cur.ids == ids
            full = _ref_continuation(ids, max_new)
            assert cur.emitted == full[:len(cur.emitted)]
            assert max_new - len(cur.emitted) > 0   # drained mid-flight
            resumed = b.submit(ids, max_new, timeout=120,
                               emitted=cur.emitted)
            assert resumed == full
        finally:
            a.close()
            b.close()

    def test_close_is_idempotent_with_concurrent_drain(self):
        srv = ContinuousLMServer(_mk_model(), slots=1, max_len=32,
                                 greedy=True, device="cpu",
                                 registry=MetricsRegistry())
        try:
            threads = ([threading.Thread(target=srv.drain)
                        for _ in range(3)]
                       + [threading.Thread(target=srv.close)
                          for _ in range(3)])
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert srv.drain_reason is not None
            assert srv.dead_reason is None
            srv.close()                   # and again, after everything
            with pytest.raises(ServerDraining):
                srv.submit([1, 2], 2, timeout=5)
        finally:
            srv.close()

    def test_drains_total_counts_once(self):
        reg = MetricsRegistry()
        srv = ContinuousLMServer(_mk_model(), slots=1, max_len=32,
                                 greedy=True, registry=reg, device="cpu")
        try:
            srv.drain("a")
            srv.drain("b")                 # second call: no-op
            assert instruments(reg).serving_drains_total.value == 1
            assert srv.drain_reason == "a"
        finally:
            srv.close()
