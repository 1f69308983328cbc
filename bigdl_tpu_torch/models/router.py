"""Fleet router: health-aware dispatch over N serving replicas
(counterpart of ``bigdl_tpu/models/router.py``, copied).

A ``ContinuousLMServer`` can die (decode failure -> ``dead``) or be
preempted (SIGTERM -> ``draining``); either way its accepted requests
leave as ``HandoffCursor``s — host-side prompt + emitted tokens that
survive any device-state loss. This router turns those cursors into zero
request loss:

- **dispatch**: least-loaded over the healthy replicas (``queue_depth``
  plus the router's own in-flight count per replica — a replica whose
  queue is empty but whose slots are saturated with this router's
  requests is not "idle"), round-robin tie-break;
- **retry**: a rejected dispatch (the replica died/drained before
  accepting) retries against another replica, bounded by ``max_retries``
  with exponential backoff;
- **requeue**: a request interrupted AFTER acceptance comes back as
  ``ServerDraining``/``ServerDead`` carrying its cursor; the router
  re-dispatches ``prompt + emitted`` to a peer, which re-prefills it in
  chunks. On the TPU that continuation is bit-identical to the unkilled
  run; on a CUDA card chunked prefill and step decode may differ in the
  last bits, so the drills hold it to equal greedy tokens and, where a
  token differs, to a teacher-forced gap bound;
- **disaggregation**: with ``prefill_replicas`` configured, admission
  prefill runs on a DEDICATED prefill replica (``prefill_handoff`` ->
  serialized b=1 state partition, ``bigdl_handoff_seconds``) and only
  the partition ships to the decode replica. If every prefill replica
  is unhealthy (or a chaos injector drops the handoff in transit) the
  router falls back to local prefill on the decode replica.

Transport: in-process (replicas are server OBJECTS, as in ``serve
--replicas N``); ``make_http_server`` fronts it unchanged, since it
duck-types the server surface (``submit``/``queue_depth``/
``batches_served``/``dead_reason``) and adds ``health_extra`` so
``GET /health`` reports per-replica states. No worker threads of its
own: ``submit()`` runs on the calling client thread, so the only shared
state is the replica table + tie-break counter (lock-guarded).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

from bigdl_tpu_torch.models.serving import ReplicaUnavailable, ServerDead
from bigdl_tpu_torch.telemetry import get_registry, instruments

__all__ = ["Replica", "LMRouter"]


class Replica:
    """One routed replica: a server object plus its fleet metadata."""

    def __init__(self, server, name: Optional[str] = None,
                 role: str = "decode"):
        if role not in ("decode", "prefill"):
            raise ValueError(f"role must be 'decode' or 'prefill', "
                            f"got {role!r}")
        self.server = server
        self.name = name or f"{role}-{id(server):x}"
        self.role = role
        # router-side in-flight count: submits this router has parked on
        # the replica (its queue_depth drops to 0 the moment a request
        # is ADMITTED into a slot, which is exactly when the slot stops
        # being free — without this, a saturated replica looks idle).
        # Written by many client threads; the OWNING router's lock
        # serializes every mutation.
        self.inflight = 0

    @property
    def state(self) -> str:
        if self.server.dead_reason is not None:
            return "dead"
        if getattr(self.server, "drain_reason", None) is not None:
            return "draining"
        return "ok"

    @property
    def healthy(self) -> bool:
        return self.state == "ok"

    @property
    def load(self) -> int:
        return int(self.server.queue_depth) + self.inflight

    def describe(self) -> dict:
        d = {"name": self.name, "role": self.role, "state": self.state,
             "queue_depth": int(self.server.queue_depth),
             "inflight": self.inflight}
        if self.state == "dead":
            d["dead"] = self.server.dead_reason
        elif self.state == "draining":
            d["draining"] = self.server.drain_reason
        return d


def _as_replica(obj, role: str, idx: int) -> Replica:
    if isinstance(obj, Replica):
        return obj
    return Replica(obj, name=f"{role}-{idx}", role=role)


class LMRouter:
    """Health-aware least-loaded router over N replicas (see module
    docstring). Exposes the ``submit()/queue_depth/batches_served/
    dead_reason`` surface of a single server, so ``make_http_server``
    and the scoreboard drive a fleet exactly like one replica."""

    def __init__(self, replicas: Sequence, *,
                 prefill_replicas: Sequence = (),
                 max_retries: int = 4, backoff_s: float = 0.02,
                 registry=None, chaos=None):
        if not replicas:
            raise ValueError("router needs at least one decode replica")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.registry = registry if registry is not None else get_registry()
        self._tm = instruments(self.registry)
        self.replicas = [_as_replica(r, "decode", i)
                         for i, r in enumerate(replicas)]
        self.prefill_replicas = [_as_replica(r, "prefill", i)
                                 for i, r in enumerate(prefill_replicas)]
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        # serving-plane chaos injectors with an on_handoff hook (the
        # drop-one-handoff drill) fire in _ship_prefill
        self._chaos = [inj for inj in (chaos or [])
                       if hasattr(inj, "on_handoff")]
        # guards the tie-break counter and every Replica.inflight
        # mutation (submit() runs on many client threads at once)
        self._lock = threading.Lock()
        self._rr = 0

    # ------------------------------------------------------------ dispatch
    def _pick(self, pool: List[Replica]) -> Optional[Replica]:
        """Least-loaded healthy replica; round-robin among ties so equal
        replicas share traffic instead of replica 0 taking everything."""
        live = [r for r in pool if r.healthy]
        if not live:
            return None
        with self._lock:
            self._rr += 1
            best = min(range(len(live)),
                       key=lambda i: (live[i].load,
                                      (i - self._rr) % len(live)))
            rep = live[best]
            rep.inflight += 1
        return rep

    def _release(self, rep: Replica) -> None:
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)

    def _chaos_drop(self) -> bool:
        for inj in self._chaos:
            if inj.on_handoff(self):
                return True
        return False

    def _ship_prefill(self, ids: List[int],
                      emitted: List[int]) -> Optional[bytes]:
        """Disaggregation's ship: run the prefill on a dedicated prefill
        replica and return the serialized partition — or None to fall
        back to local prefill on the decode replica (no healthy prefill
        replica, or the bounded ship retries ran dry)."""
        for attempt in range(self.max_retries + 1):
            rep = self._pick(self.prefill_replicas)
            if rep is None:
                return None
            try:
                t0 = time.perf_counter()
                blob = rep.server.prefill_handoff(
                    ids, emitted if emitted else None)
                self._tm.handoff_seconds.observe(
                    time.perf_counter() - t0)
            except ReplicaUnavailable:
                self._tm.router_retries_total.inc()
                continue
            finally:
                self._release(rep)
            if self._chaos_drop():
                # the partition evaporated in transit (chaos
                # drop-handoff): re-ship — prefill is deterministic, a
                # second partition is the same partition
                self._tm.router_retries_total.inc()
                continue
            return blob
        return None

    # ---------------------------------------------------------- client API
    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None,
               timeout: Optional[float] = None) -> List[int]:
        """Serve one prompt through the fleet. Zero-loss contract: a
        replica failing or draining mid-request only moves the request —
        its cursor re-dispatches to a peer, which continues the greedy
        generation from ``prompt + emitted``."""
        self._tm.router_requests_total.inc()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        emitted: List[int] = []
        attempt = 0
        last_err: Optional[str] = None
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        "request did not complete within the timeout"
                        + (f" (last replica error: {last_err})"
                           if last_err else ""))
            state = (self._ship_prefill(list(prompt_ids), emitted)
                     if self.prefill_replicas else None)
            rep = self._pick(self.replicas)
            if rep is None:
                raise ServerDead(
                    "no healthy replicas"
                    + (f" (last replica error: {last_err})"
                       if last_err else ""))
            try:
                return rep.server.submit(prompt_ids, max_new_tokens,
                                         remaining,
                                         emitted=emitted or None,
                                         state=state)
            except ReplicaUnavailable as e:
                last_err = f"{rep.name}: {e}"
                if e.cursor is not None:
                    # the request had been ACCEPTED there — take the
                    # cursor's progress (a superset of ours: it includes
                    # any prefix we resumed it with) and requeue
                    emitted = list(e.cursor.emitted)
                    self._tm.router_requeues_total.inc()
                attempt += 1
                if attempt > self.max_retries:
                    raise
                self._tm.router_retries_total.inc()
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            finally:
                self._release(rep)

    # ------------------------------------------- single-server duck typing
    @property
    def queue_depth(self) -> int:
        return sum(r.server.queue_depth for r in self.replicas
                   if r.healthy)

    @property
    def batches_served(self) -> int:
        return sum(r.server.batches_served for r in self.replicas)

    @property
    def dead_reason(self) -> Optional[str]:
        """The fleet is only 'dead' when NO decode replica can serve —
        one dead replica is routine (that is the point of a router)."""
        if any(r.healthy for r in self.replicas):
            return None
        return "no healthy replicas: " + "; ".join(
            f"{r.name}={r.state}" for r in self.replicas)

    @property
    def health_extra(self) -> dict:
        """Per-replica detail merged into ``GET /health`` by
        ``make_http_server``."""
        return {"replicas": [r.describe() for r in
                             self.replicas + self.prefill_replicas]}

    def drain(self, reason: str = "router drain") -> None:
        """Drain every replica exactly once (the whole-fleet SIGTERM
        path; a server may back both a decode and a prefill replica)."""
        seen = set()
        for r in self.replicas + self.prefill_replicas:
            drain = getattr(r.server, "drain", None)
            if drain is None or id(r.server) in seen:
                continue
            seen.add(id(r.server))
            drain(reason)

    def close(self) -> None:
        """Close every replica exactly once (replicas may share a
        server object across roles)."""
        seen = set()
        for r in self.replicas + self.prefill_replicas:
            if id(r.server) in seen:
                continue
            seen.add(id(r.server))
            r.server.close()
