"""The port's ``ContinuousLMServer``: scheduling, bounds, validation and
lifecycle, on the CPU.

Answers are held to the port's ``generate`` on a second instance of the
same model (``tests/test_torch_serving.py`` holds both to the reference's
server), greedy tokens identical. Covered here: more requests than slots
over enough rounds that free and overrunning rows pass the cache end (the
write guard of ``_attend_decode_continuous``), mixed lengths in flight, eos,
budget and configuration checks, drain with handoff cursors, the dead
state, prefill handoff (the reference's wire format too) and ``/health``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.models.serving import ContinuousLMServer as JaxServer
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.interop.state_dict import import_lm_state_dict
from bigdl_tpu_torch.models.generation import (deserialize_prefill_state,
                                               generate)
from bigdl_tpu_torch.models.lm_server import make_http_server
from bigdl_tpu_torch.models.serving import (ContinuousLMServer, ServerDead,
                                            ServerDraining)
from bigdl_tpu_torch.models.transformer import build_lm

torch.set_num_threads(1)

V = 500
LM = dict(embed_dim=64, num_heads=4, num_kv_heads=2, ffn_dim=128,
          num_layers=2, max_len=64, rope=True, activation="swiglu",
          norm="rms", bias=False, fused_head=True)


def _model(seed=3):
    return build_lm(V, **LM, device="cpu", seed=seed).evaluate_mode()


_REF = {}


def _want(ids, max_new, seed=3):
    """The port's greedy ``generate`` on its own instance of the model."""
    if seed not in _REF:
        _REF[seed] = _model(seed)
    return generate(_REF[seed], [ids], max_new, greedy=True,
                    device="cpu")[0, len(ids):].tolist()


def _prompt(n, seed=0):
    return np.random.default_rng([n, seed]).integers(1, V + 1, n).tolist()


def _serve_threads(srv, jobs, timeout=120):
    results = [None] * len(jobs)

    def client(i):
        results[i] = srv.submit(*jobs[i], timeout=timeout)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)
    return results


def test_rows_past_the_cache_end_stay_in_bounds():
    """One request that fills the cache (prompt + budget == max_len) with
    (budget - 1) not a multiple of decode_block: its row runs three steps
    past the cache end in the last block, and the free slot's position
    passes the end too. Without the write guard the step raises
    IndexError and the server dies."""
    srv = ContinuousLMServer(_model(), slots=2, max_len=32, greedy=True,
                             decode_block=4, device="cpu")
    try:
        ids = _prompt(2)
        got = srv.submit(ids, 30, timeout=120)
        assert srv.decode_blocks == 8           # 29 steps in blocks of 4
        assert srv.dead_reason is None
        assert got == _want(ids, 30)
        # a second request into the slot whose position ran past the end
        ids = _prompt(5)
        assert srv.submit(ids, 6, timeout=120) == _want(ids, 6)
    finally:
        srv.close()


def test_more_requests_than_slots_over_many_rounds():
    """A request that fills its row (2 + 30 == max_len, 29 steps in blocks
    of 4, so its row runs past the end), and meanwhile eight short ones of
    mixed lengths through the other slot."""
    srv = ContinuousLMServer(_model(), slots=2, max_len=32, greedy=True,
                             decode_block=4, device="cpu")
    jobs = [(_prompt(2), 30)] + [(_prompt(1 + i % 5, seed=i), 3 + i % 4)
                                 for i in range(8)]
    # the highest row position after each decode block
    positions, step = [], srv._step

    def spy():
        out = step()
        positions.append(int(srv._pipeline.mhas[0].decode_pos.max()))
        return out

    srv._step = spy
    try:
        long_job = threading.Thread(
            target=lambda: jobs.append(srv.submit(*jobs[0], timeout=120)))
        long_job.start()
        deadline = time.time() + 60
        while srv.requests_admitted < 1 and time.time() < deadline:
            time.sleep(0.005)
        results = _serve_threads(srv, jobs[1:])
        long_job.join(timeout=120)
        assert srv.dead_reason is None
        for (ids, mx), got in zip(jobs, [jobs.pop()] + results):
            assert got == _want(ids, mx)
        assert srv.decode_blocks >= 8
        assert max(positions) > 32              # a row passed the cache end
        assert sorted(srv._free) == [0, 1] and not srv._active
    finally:
        srv.close()


def test_mixed_lengths_and_budgets_in_flight():
    srv = ContinuousLMServer(_model(), slots=4, max_len=48, greedy=True,
                             decode_block=3, prefill_chunk=4, device="cpu")
    jobs = [([5], 7), (_prompt(4), 5), (_prompt(7), 9), (_prompt(2), 4),
            (_prompt(13), 8), (_prompt(8), 6)]
    try:
        results = _serve_threads(srv, jobs)
        for (ids, mx), got in zip(jobs, results):
            assert got == _want(ids, mx)
    finally:
        srv.close()


def test_eos_frees_the_slot_early():
    ids = _prompt(4)
    full = _want(ids, 10)
    eos = full[2]
    srv = ContinuousLMServer(_model(), slots=1, max_len=32, greedy=True,
                             eos_id=eos, decode_block=4, device="cpu")
    try:
        assert srv.submit(ids, 10, timeout=120) == full[:full.index(eos) + 1]
        # the slot is free again: a second request is served
        assert srv.submit(_prompt(3), 2, timeout=120) == _want(_prompt(3), 2)
    finally:
        srv.close()


def test_budget_validation():
    srv = ContinuousLMServer(_model(), slots=1, max_len=16, greedy=True,
                             device="cpu")
    try:
        with pytest.raises(ValueError, match="max_len"):
            srv.submit(list(range(1, 13)), max_new_tokens=8)
        with pytest.raises(ValueError, match="empty"):
            srv.submit([])
        with pytest.raises(ValueError, match=">= 1"):
            srv.submit([1], max_new_tokens=0)
    finally:
        srv.close()


@pytest.mark.parametrize("kw, error, match", [
    (dict(prefill_mode="monolithic"), ValueError, "prefill_mode"),
    (dict(prefill_chunk=0), ValueError, "prefill_chunk"),
    (dict(slots=0), ValueError, "slots"),
    (dict(draft="self", greedy=True), ValueError, "separate"),
    (dict(draft="other"), ValueError, "greedy-only"),
    (dict(draft="other", greedy=True, spec_len=0), ValueError, "spec_len"),
    (dict(registry=object()), AttributeError, "from_spec"),
    (dict(chaos=5), TypeError, "not iterable"),
])
def test_rejects_bad_configuration(kw, error, match):
    model = _model()
    if kw.get("draft") == "self":
        kw["draft"] = model
    elif kw.get("draft") == "other":
        kw["draft"] = _model(4)
    with pytest.raises(error, match=match):
        ContinuousLMServer(model, max_len=16, device="cpu", **kw)


def test_rejects_a_non_rope_model():
    m = build_lm(V, embed_dim=32, num_heads=2, ffn_dim=32, num_layers=1,
                 max_len=32, tie_embeddings=True, device="cpu", seed=0)
    with pytest.raises(ValueError, match="rope"):
        ContinuousLMServer(m, slots=1, max_len=16, device="cpu")


def test_chunk_wider_than_the_cache_is_clamped():
    srv = ContinuousLMServer(_model(), slots=1, max_len=16, greedy=True,
                             prefill_chunk=1 << 20, device="cpu")
    try:
        assert srv.prefill_chunk == 16 and srv._pipeline.cache_len == 16
        assert srv.submit(_prompt(3), 3, timeout=120) == _want(_prompt(3), 3)
    finally:
        srv.close()


def test_generate_refuses_a_served_model():
    model = _model()
    srv = ContinuousLMServer(model, slots=1, max_len=16, greedy=True,
                             device="cpu")
    try:
        with pytest.raises(ValueError, match="ContinuousLMServer"):
            generate(model, [[1, 2]], 2, greedy=True, device="cpu")
    finally:
        srv.close()
    # closing gives the model back
    assert generate(model, [[1, 2]], 2, greedy=True,
                    device="cpu").shape == (1, 4)


def test_drain_hands_off_cursors_that_resume_on_a_peer():
    """Drain mid-generation: the running request and the queued ones raise
    ServerDraining with cursors; a fresh server given each cursor
    (``emitted=``) returns the undrained answer."""
    a = ContinuousLMServer(_model(), slots=1, max_len=48, greedy=True,
                           decode_block=1, device="cpu")
    jobs = [(_prompt(4), 12), (_prompt(6), 5), (_prompt(3), 5)]
    cursors = {}

    def client(i):
        try:
            a.submit(*jobs[i], timeout=120)
        except ServerDraining as e:
            cursors[i] = e.cursor

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 60
        while a.requests_admitted < 1 and time.time() < deadline:
            time.sleep(0.01)
        a.drain("preemption notice")
        for t in threads:
            t.join(timeout=60)
        assert a.drain_reason == "preemption notice"
        assert a.dead_reason is None
        with pytest.raises(ServerDraining, match="draining"):
            a.submit([2, 2], 3, timeout=120)
    finally:
        a.close()
    assert sorted(cursors) == [0, 1, 2]
    assert 0 < len(cursors[0].emitted) < 12     # cut mid-flight
    b = ContinuousLMServer(_model(), slots=2, max_len=48, greedy=True,
                           decode_block=2, device="cpu")
    try:
        for i, (ids, mx) in enumerate(jobs):
            cur = cursors[i]
            assert cur.ids == ids and cur.max_new == mx
            assert b.submit(cur.ids, cur.max_new, timeout=120,
                            emitted=cur.emitted) == _want(ids, mx)
    finally:
        b.close()


def test_close_is_idempotent_with_concurrent_drain():
    srv = ContinuousLMServer(_model(), slots=1, max_len=32, greedy=True,
                             device="cpu")
    threads = ([threading.Thread(target=srv.drain) for _ in range(3)]
               + [threading.Thread(target=srv.close) for _ in range(3)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert srv.drain_reason is not None and srv.dead_reason is None
    srv.close()
    with pytest.raises(ServerDraining):
        srv.submit([1, 2], 2, timeout=5)


def test_step_failure_kills_the_server_and_fails_fast():
    srv = ContinuousLMServer(_model(), slots=2, max_len=32, greedy=True,
                             decode_block=4, device="cpu")
    try:
        assert len(srv.submit([3, 7, 2], 4, timeout=120)) == 4

        def boom():
            raise RuntimeError("injected step failure")

        srv._step = boom
        with pytest.raises(ServerDead, match="injected step failure") as err:
            srv.submit([5, 1, 4], 8, timeout=120)
        assert err.value.cursor.ids == [5, 1, 4]
        assert "injected step failure" in srv.dead_reason
        t0 = time.perf_counter()
        with pytest.raises(ServerDead, match="server is dead"):
            srv.submit([2, 2], 4, timeout=120)
        assert time.perf_counter() - t0 < 1.0
    finally:
        srv.close()


def test_concurrent_submits_and_close_keep_slots_consistent():
    srv = ContinuousLMServer(_model(), slots=3, max_len=32, greedy=True,
                             decode_block=2, device="cpu")
    outcomes = []

    def client(i):
        try:
            outcomes.append(srv.submit([1 + i % 5] * (1 + i % 3), 4,
                                       timeout=60))
        except (RuntimeError, TimeoutError) as e:
            outcomes.append(str(e))     # a failure mid-close is allowed

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    srv.close()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(outcomes) == 8
    assert sorted(srv._free) == [0, 1, 2] and not srv._active


@pytest.mark.parametrize("mode", ["chunked", "bucketed"])
def test_prefill_handoff_equals_a_local_prefill(mode):
    ids, mx = _prompt(9), 8
    a = ContinuousLMServer(_model(), slots=1, max_len=48, greedy=True,
                           prefill_chunk=4, prefill_mode=mode, device="cpu")
    b = ContinuousLMServer(_model(), slots=2, max_len=48, greedy=True,
                           decode_block=2, prefill_chunk=4,
                           prefill_mode=mode, device="cpu")
    try:
        blob = a.prefill_handoff(ids)
        lp, state = deserialize_prefill_state(blob)
        assert lp.shape == (1, V) and len(state) == 3 * LM["num_layers"]
        # decode_pos: the prompt length, or the bucket's (the insert
        # sets the row's position to the prompt length either way)
        assert state[0] == (len(ids) if mode == "chunked" else 16)
        assert b.submit(ids, mx, timeout=120, state=blob) == _want(ids, mx)
        a.drain("going away")
        with pytest.raises(ServerDraining):
            a.prefill_handoff(ids)
    finally:
        a.close()
        b.close()


def test_handoff_from_a_reference_replica():
    """The reference's prefill replica ships its npz blob; the port's decode
    replica over the same weights continues as the reference would."""
    manual_seed(5)
    jm = jax_transformer.build_lm(V, **LM).evaluate_mode()
    tm = _model()
    import_lm_state_dict(tm, jax_export(jm))
    ids, mx = _prompt(7), 6
    ref = JaxServer(jm, slots=1, max_len=32, greedy=True, prefill_chunk=4)
    srv = ContinuousLMServer(tm, slots=1, max_len=32, greedy=True,
                             prefill_chunk=4, device="cpu")
    try:
        blob = ref.prefill_handoff(ids)
        want = ref.submit(ids, mx, timeout=120)
        assert srv.submit(ids, mx, timeout=120, state=blob) == want
        with pytest.raises(RuntimeError, match="shape"):
            srv.submit(ids, mx, timeout=120, state=_foreign_blob(ids))
    finally:
        ref.close()
        srv.close()


def _foreign_blob(ids):
    """A blob from a replica with another chunk (another cache length)."""
    srv = ContinuousLMServer(_model(), slots=1, max_len=32, greedy=True,
                             prefill_chunk=5, device="cpu")
    try:
        return srv.prefill_handoff(ids)
    finally:
        srv.close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("end", ["draining", "dead"])
def test_http_health_reports_draining_and_dead(end):
    srv = ContinuousLMServer(_model(), slots=1, max_len=32, greedy=True,
                             decode_block=2, device="cpu")
    http = make_http_server(srv, "127.0.0.1", 0)
    worker = threading.Thread(target=http.serve_forever, daemon=True)
    worker.start()
    base = f"http://127.0.0.1:{http.server_address[1]}"
    try:
        ids = _prompt(3)
        req = urllib.request.Request(
            base + "/generate",
            data=json.dumps({"prompt": ids, "max_new_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read())["ids"] == _want(ids, 3)
        code, body = _get(base + "/health")
        assert code == 200 and body["ok"] and body["batches_served"] == 1
        if end == "draining":
            srv.drain("rolling restart")
        else:
            def boom():
                raise RuntimeError("injected")
            srv._step = boom
            with pytest.raises(ServerDead):
                srv.submit(ids, 3, timeout=60)
        code, body = _get(base + "/health")
        assert code == 503 and not body["ok"] and end in body
    finally:
        http.shutdown()
        http.server_close()
        srv.close()
        worker.join(timeout=10)
