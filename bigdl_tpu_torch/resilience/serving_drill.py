"""The kill-one-replica serving drill (counterpart of
``bigdl_tpu/resilience/serving_drill.py``; ``python -m
bigdl_tpu_torch.resilience chaos drill``).

An executable statement of the fleet's zero-loss contract: build a tiny
in-process fleet behind ``LMRouter``, attach a ``KillReplicaAfterRequests``
injector to decode replica 0 so it dies mid-stream through the REAL die
path, drive a batch of concurrent greedy requests, and check that every
request completes with the greedy output of an unkilled ``generate`` on
the same device. Every replica is built from one seed through
``build_lm(seed=)``, so the weights are bit-identical across the fleet.

A peer finishes a killed request by re-prefilling ``prompt + emitted`` in
chunks. On a CUDA card chunked prefill and step decode may round apart in
the last bits, so an answer that differs from ``generate`` is held to the
teacher-forced gap bound ``gap_tol`` instead (its positions are reported).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["run_kill_drill", "parse_split"]

VOCAB = 24


def _mk_model(seed: int = 4, device="cuda"):
    """The test-sized LM every replica shares (the reference's ``_mk_model``
    widths; identical weights from one seed)."""
    from bigdl_tpu_torch.models.transformer import build_lm

    return build_lm(VOCAB, 16, 2, 32, num_layers=2, max_len=64, rope=True,
                    activation="swiglu", norm="rms", tie_embeddings=True,
                    device=device, seed=seed).evaluate_mode()


def parse_split(spec: Optional[str]):
    """``'P:D'`` -> (prefill, decode) counts, or None for aggregated."""
    if not spec:
        return None
    p_s, sep, d_s = spec.partition(":")
    try:
        p, d = int(p_s), int(d_s)
    except ValueError:
        raise ValueError(f"bad disaggregate spec {spec!r}: expected P:D "
                         f"(e.g. 1:2)") from None
    if not sep or p < 1 or d < 1:
        raise ValueError(f"bad disaggregate spec {spec!r}: expected P:D "
                         f"with both counts >= 1")
    return p, d


def greedy_gap(model, prompt, answer) -> float:
    """The largest gap between a served token's log-prob and its position's
    largest, with ``prompt + answer`` teacher-forced through ``model``."""
    import torch

    from bigdl_tpu_torch.utils.device import module_device

    dev = module_device(model)
    with torch.inference_mode():
        ids = torch.as_tensor([list(prompt) + list(answer)], device=dev)
        lp = model(ids)[0, len(prompt) - 1:-1].float()
        tok = torch.as_tensor(answer, device=dev)[:, None] - 1
        return (lp.max(dim=-1).values - lp.gather(1, tok)[:, 0]).max().item()


def run_kill_drill(replicas: int = 2, disaggregate: Optional[str] = None,
                   requests: int = 6, kill_after: int = 2,
                   max_new: int = 6, timeout: float = 120.0,
                   device="cuda", gap_tol: float = 1e-3) -> dict:
    """Run the drill; return a JSON-able report with an ``ok`` verdict."""
    import threading

    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.router import LMRouter
    from bigdl_tpu_torch.models.serving import ContinuousLMServer
    from bigdl_tpu_torch.resilience.chaos import KillReplicaAfterRequests
    from bigdl_tpu_torch.telemetry import MetricsRegistry, instruments

    split = parse_split(disaggregate)
    n_decode = split[1] if split else int(replicas)
    n_prefill = split[0] if split else 0
    if n_decode < 2:
        raise ValueError("the kill drill needs >= 2 decode replicas "
                         "(killing the only one proves nothing)")

    registry = MetricsRegistry()
    kill = KillReplicaAfterRequests(kill_after)
    decode = [ContinuousLMServer(_mk_model(device=device), slots=2,
                                 max_len=48, greedy=True, decode_block=2,
                                 registry=registry, device=device,
                                 chaos=[kill] if i == 0 else None)
              for i in range(n_decode)]
    prefill = [ContinuousLMServer(_mk_model(device=device), slots=1,
                                  max_len=48, greedy=True, registry=registry,
                                  device=device)
               for _ in range(n_prefill)]
    router = LMRouter(decode, prefill_replicas=prefill, registry=registry)

    prompts = [[(3 * i + j) % (VOCAB - 1) + 1 for j in range(2 + i % 3)]
               for i in range(int(requests))]
    results = [None] * len(prompts)
    errors = [None] * len(prompts)

    def worker(i):
        try:
            results[i] = router.submit(prompts[i], max_new, timeout=timeout)
        except Exception as e:  # the drill REPORTS losses, not crashes
            errors[i] = f"{type(e).__name__}: {e}"

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
        ref = _mk_model(device=device)
        mismatched, worst_gap = [], 0.0
        for i, ids in enumerate(prompts):
            if errors[i] is not None:
                continue
            want = generate(ref, [ids], max_new, greedy=True,
                            device=device)[0, len(ids):].tolist()
            if results[i] != want:
                gap = greedy_gap(ref, ids, results[i])
                worst_gap = max(worst_gap, gap)
                mismatched.append({
                    "i": i, "gap": gap,
                    "positions": [j for j, (a, b) in enumerate(
                        zip(results[i], want)) if a != b]})
        lost = [i for i in range(len(prompts)) if errors[i] is not None]
        tm = instruments(registry)
        return {
            "ok": (not lost and kill.fired and worst_gap <= gap_tol
                   and all(len(results[i]) == max_new
                           for i in range(len(prompts)))),
            "requests": len(prompts),
            "lost": [{"i": i, "error": errors[i]} for i in lost],
            "mismatched": mismatched,
            "gap_tol": gap_tol,
            "kill_fired": kill.fired,
            "kill_after": kill_after,
            "decode_replicas": n_decode,
            "prefill_replicas": n_prefill,
            "replica_states": [r["state"] for r in
                               router.health_extra["replicas"]],
            "requeues": int(tm.router_requeues_total.value),
            "retries": int(tm.router_retries_total.value),
        }
    finally:
        router.close()
