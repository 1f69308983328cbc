"""The port's serving fleet on the CPU, against the reference.

Weights are the reference fleet tests' ``_mk_model`` (VOCAB 24, E=16, two
layers, the Llama recipe, tied head; ``resilience/serving_drill.py``'s drill
size), carried across with ``import_lm_state_dict``. Covered: the prefill
handoff round trip; the kill-one-replica drill and the disaggregated drill
with a dropped handoff, every answer token-equal to the reference's greedy
``generate``; the port's own ``run_kill_drill``; and the metrics of
``ContinuousLMServer`` and ``LMServer`` after a round of requests, equal to
the reference servers' counts for the same requests
(``bigdl_serving_recompiles_total`` excepted: the port builds no programs).
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
from bigdl_tpu.models.generation import generate as jax_generate
from bigdl_tpu.models.lm_server import LMServer as JaxLMServer
from bigdl_tpu.models.serving import ContinuousLMServer as JaxServer
from bigdl_tpu.telemetry import MetricsRegistry as JaxRegistry
from bigdl_tpu.telemetry import instruments as jax_instruments
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.interop.state_dict import import_lm_state_dict
from bigdl_tpu_torch.models.generation import deserialize_prefill_state
from bigdl_tpu_torch.models.lm_server import LMServer, make_http_server
from bigdl_tpu_torch.models.router import LMRouter
from bigdl_tpu_torch.models.serving import ContinuousLMServer, ServerDraining
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.resilience.chaos import (DropHandoff,
                                              KillReplicaAfterRequests)
from bigdl_tpu_torch.resilience.serving_drill import run_kill_drill
from bigdl_tpu_torch.telemetry import MetricsRegistry, instruments

torch.set_num_threads(1)

VOCAB = 24
FLEET_LM = dict(embed_dim=16, num_heads=2, ffn_dim=32, num_layers=2,
                max_len=64, rope=True, activation="swiglu", norm="rms",
                tie_embeddings=True)
PROMPTS = [[3, 7, 2, 9], [5, 1], [8, 8, 4], [2, 6, 6, 1, 9], [4, 4],
           [9, 1, 3]]
MAX_NEW = 6
_CACHE = {}


def _jax_model():
    """The reference fleet tests' ``_mk_model`` (seed 4)."""
    if "jax" not in _CACHE:
        manual_seed(4)
        _CACHE["jax"] = jax_transformer.build_lm(VOCAB, **FLEET_LM)
    return _CACHE["jax"]


def _mk_model():
    tm = build_lm(VOCAB, **FLEET_LM, device="cpu", seed=0)
    import_lm_state_dict(tm, jax_export(_jax_model()))
    return tm.evaluate_mode()


def _reference(prompts, max_new=MAX_NEW):
    """The reference's greedy continuations, one batch per prompt length."""
    out = {}
    for n in sorted({len(p) for p in prompts}):
        group = [p for p in prompts if len(p) == n]
        rows = np.asarray(jax_generate(_jax_model(), jnp.asarray(
            np.asarray(group, np.float32)), max_new, greedy=True))
        for p, row in zip(group, rows[:, n:].astype(int).tolist()):
            out[tuple(p)] = row
    return [out[tuple(p)] for p in prompts]


def _drive(router, prompts, max_new=MAX_NEW):
    results, errors = [None] * len(prompts), []

    def worker(i):
        try:
            results[i] = router.submit(prompts[i], max_new, timeout=120)
        except Exception as e:  # collected: a lost request fails the test
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return results


def test_prefill_handoff_roundtrip_and_peer_continues():
    a = ContinuousLMServer(_mk_model(), slots=1, max_len=48, greedy=True,
                           device="cpu", registry=MetricsRegistry())
    b = ContinuousLMServer(_mk_model(), slots=2, max_len=48, greedy=True,
                           decode_block=2, device="cpu",
                           registry=MetricsRegistry())
    ids = [5, 11, 3, 8, 2]
    try:
        blob = a.prefill_handoff(ids)
        lp, state = deserialize_prefill_state(blob)
        lp2, _ = deserialize_prefill_state(blob)
        assert torch.equal(lp, lp2) and lp.shape == (1, VOCAB) and state
        assert b.submit(ids, 8, timeout=120, state=blob) == _reference(
            [ids], 8)[0]
        a.drain("going away")
        with pytest.raises(ServerDraining):
            a.prefill_handoff([1, 2, 3])
    finally:
        a.close()
        b.close()


def test_kill_one_replica_loses_nothing():
    """Replica 0 dies mid-stream through the real die path; every request
    completes on the peer through its cursor, token-equal to the
    reference's unkilled greedy run."""
    reg = MetricsRegistry()
    kill = KillReplicaAfterRequests(2)
    decode = [ContinuousLMServer(_mk_model(), slots=2, max_len=48,
                                 greedy=True, decode_block=2, registry=reg,
                                 device="cpu",
                                 chaos=[kill] if i == 0 else None)
              for i in range(2)]
    router = LMRouter(decode, registry=reg, backoff_s=0.001)
    try:
        got = _drive(router, PROMPTS)
        assert got == _reference(PROMPTS)
        tm = instruments(reg)
        assert kill.fired and tm.router_requeues_total.value >= 1
        assert [r["state"] for r in router.health_extra["replicas"]] == [
            "dead", "ok"]
        assert tm.router_requests_total.value == len(PROMPTS)
        assert tm.serving_request_errors_total.value >= 1
    finally:
        router.close()


def test_disaggregated_drill_with_dropped_handoff():
    """A 1:2 prefill:decode fleet where chaos drops a shipped partition in
    transit and a decode replica is killed: re-ship plus requeue lose
    nothing."""
    reg = MetricsRegistry()
    kill = KillReplicaAfterRequests(1)
    decode = [ContinuousLMServer(_mk_model(), slots=2, max_len=48,
                                 greedy=True, decode_block=2, registry=reg,
                                 device="cpu",
                                 chaos=[kill] if i == 0 else None)
              for i in range(2)]
    prefill = [ContinuousLMServer(_mk_model(), slots=1, max_len=48,
                                  greedy=True, registry=reg, device="cpu")]
    router = LMRouter(decode, prefill_replicas=prefill, registry=reg,
                      chaos=[DropHandoff(2)], backoff_s=0.001)
    try:
        prompts = PROMPTS[:4]
        assert _drive(router, prompts) == _reference(prompts)
        tm = instruments(reg)
        assert tm.handoff_seconds.labels().snapshot()["count"] >= 1
        assert tm.router_retries_total.value >= 1   # the drop re-ship
    finally:
        router.close()


@pytest.mark.parametrize("split", [None, "1:2"])
def test_port_drill_reports_ok(split):
    report = run_kill_drill(replicas=2, disaggregate=split, requests=4,
                            kill_after=1, max_new=5, device="cpu")
    assert report["ok"] and report["kill_fired"]
    assert report["lost"] == [] and report["mismatched"] == []
    assert report["requeues"] >= 1
    assert report["replica_states"][0] == "dead"


# the families whose values a round of sequential requests fixes
_SERVING = ("serving_admissions_total", "serving_requests_completed_total",
            "serving_tokens_total", "serving_request_errors_total",
            "serving_decode_blocks_total", "serving_slots_total",
            "serving_slots_occupied", "serving_queue_depth",
            "prefix_cache_hits", "prefix_cache_misses",
            "prefix_cache_evictions", "serving_drains_total")
_SERVING_H = ("serving_ttft_seconds", "serving_token_latency_seconds",
              "serving_request_latency_seconds", "serving_ttft_hit_seconds",
              "serving_ttft_miss_seconds")


def _readings(tm, names, hists):
    out = {n: getattr(tm, n).value for n in names}
    out.update({h: getattr(tm, h).labels().snapshot()["count"]
                for h in hists})
    return out


def test_continuous_server_metrics_equal_reference_counts():
    jreg, preg = JaxRegistry(), MetricsRegistry()
    kw = dict(slots=2, max_len=48, greedy=True, decode_block=2,
              prefill_chunk=4)
    jsrv = JaxServer(_jax_model(), registry=jreg, **kw)
    psrv = ContinuousLMServer(_mk_model(), registry=preg, device="cpu", **kw)
    # a second submit of a 9-token prompt hits its 8-token prefix
    prompts = PROMPTS[:3] + [[1, 2, 3, 4, 5, 6, 7, 8, 9]] * 2
    try:
        for p in prompts:   # sequential: the counts follow from the prompts
            assert psrv.submit(p, 5, timeout=120) == jsrv.submit(
                p, 5, timeout=120)
        jsrv.drain("x")
        psrv.drain("x")
        want = _readings(jax_instruments(jreg), _SERVING, _SERVING_H)
        got = _readings(instruments(preg), _SERVING, _SERVING_H)
        assert got == want and got["prefix_cache_hits"] >= 1
        assert instruments(preg).serving_recompiles_total.value == 0
        assert instruments(preg).prefix_cache_bytes.value > 0
    finally:
        jsrv.close()
        psrv.close()


def test_lm_server_metrics_equal_reference_counts_and_http():
    jreg, preg = JaxRegistry(), MetricsRegistry()
    manual_seed(5)
    jlm = jax_transformer.build_lm(VOCAB, 16, 2, 32, num_layers=1, max_len=32)
    plm = build_lm(VOCAB, 16, 2, 32, num_layers=1, max_len=32,
                   device="cpu", seed=0)
    import_lm_state_dict(plm, jax_export(jlm))
    jsrv = JaxLMServer(jlm, greedy=True, max_new_tokens=4, registry=jreg,
                       batch_timeout_ms=1)
    psrv = LMServer(plm.evaluate_mode(), greedy=True, max_new_tokens=4,
                    registry=preg, batch_timeout_ms=1, device="cpu")
    httpd = make_http_server(psrv, "127.0.0.1", 0)
    worker = threading.Thread(target=httpd.serve_forever, daemon=True)
    worker.start()
    try:
        for p in ([3, 5, 7], [2, 2], [9, 1, 1]):
            assert psrv.submit(p, timeout=60) == jsrv.submit(p, timeout=60)
        names = ("lmserver_batches_total", "lmserver_requests_total",
                 "lmserver_queue_depth")
        hists = ("lmserver_batch_size", "lmserver_batch_wait_seconds")
        assert (_readings(instruments(preg), names, hists)
                == _readings(jax_instruments(jreg), names, hists))
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            assert r.headers["Content-Type"] == (
                "text/plain; version=0.0.4; charset=utf-8")
            body = r.read().decode()
        assert "bigdl_lmserver_batches_total 3" in body.splitlines()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=10) as r:
            assert json.loads(r.read())["queue_depth"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        jsrv.close()
        psrv.close()
        worker.join(timeout=10)


def test_http_rim_passes_router_health_extra_and_refuses_a_tokenizer():
    reg = MetricsRegistry()
    router = LMRouter([ContinuousLMServer(_mk_model(), slots=1, max_len=32,
                                          greedy=True, registry=reg,
                                          device="cpu")], registry=reg)
    plain = make_http_server(router, "127.0.0.1", 0)
    httpd = make_http_server(router, "127.0.0.1", 0, tokenizer=_DigitTokenizer())
    workers = [threading.Thread(target=h.serve_forever, daemon=True)
               for h in (plain, httpd)]
    for w in workers:
        w.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(url, body):
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        # a text prompt needs a tokenizer: the rim without one refuses it
        with pytest.raises(urllib.error.HTTPError) as err:
            post(f"http://127.0.0.1:{plain.server_address[1]}",
                 {"text": "37"})
        assert err.value.code == 400
        want = _reference([[3, 7]], 4)[0]
        assert post(base, {"prompt": [3, 7], "max_new_tokens": 4}) == {
            "ids": want, "text": "".join(str(t) for t in want)}
        assert post(base, {"text": "37", "max_new_tokens": 4})["ids"] == want
        with urllib.request.urlopen(base + "/health", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and [x["state"] for x in health["replicas"]] == [
            "ok"]
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            body = r.read().decode()
        # the id POST and the text POST; the refused one never reached it
        assert "bigdl_router_requests_total 2" in body.splitlines()
    finally:
        for h in (plain, httpd):
            h.shutdown()
            h.server_close()
        router.close()
        for w in workers:
            w.join(timeout=10)


class _DigitTokenizer:
    """Text of decimal digits <-> ids, one id per digit (the tokenizer
    protocol of ``make_http_server``)."""

    def encode(self, text):
        return [int(c) for c in text]

    def decode(self, ids):
        return "".join(str(i) for i in ids)
