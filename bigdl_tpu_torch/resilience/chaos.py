"""Deterministic fault injection for resilience drills (counterpart of
``bigdl_tpu/resilience/chaos.py``; ``corrupt_snapshot`` damages a plain
snapshot file or a shard file of a sharded snapshot).

These injectors make a failure REPRODUCIBLE — kill exactly at step N,
stall exactly at step N — so a recovery test failing once fails every
time:

- ``KillAtStep`` / ``DelayAtStep``: step-boundary injectors, polled by
  ``Optimizer`` after every iteration (``set_chaos``), e.g.
  ``BIGDL_CHAOS="kill@5"`` or ``"delay@3:0.25,kill@7:SIGINT"``; a kill
  delivers a REAL signal to this process;
- ``corrupt_snapshot``: deterministic damage to a snapshot file, which
  the resume coordinator must then reject (``python -m
  bigdl_tpu_torch.resilience chaos corrupt``).
- SERVING-PLANE injectors (the fleet drill, ``python -m
  bigdl_tpu_torch.resilience chaos drill``): ``KillReplicaAfterRequests``
  (``kill-replica@N`` — the attached continuous server dies at the first
  decode-block boundary after admitting N requests, driving the REAL die
  path mid-stream), ``DelayDecodeStep`` (``delay-decode@B:S`` — stall
  decode block B for S seconds, the straggler-replica simulation), and
  ``DropHandoff`` (``drop-handoff@N`` — the router's Nth shipped prefill
  partition evaporates in transit, exercising the re-ship fallback).
  Servers poll anything with an ``on_decode_block(server)`` hook; the
  router polls ``on_handoff(router)``.

Plain Python: importable by the CLI without touching a device.
"""

from __future__ import annotations

import os
import signal
import time
from typing import List, Optional

__all__ = ["KillAtStep", "DelayAtStep", "KillReplicaAfterRequests",
           "DelayDecodeStep", "DropHandoff", "ChaosReplicaKill",
           "corrupt_snapshot", "parse_spec", "from_env"]


class ChaosReplicaKill(RuntimeError):
    """Raised inside a serving worker's decode dispatch by
    ``KillReplicaAfterRequests`` — lands in the server's die path
    exactly like a real decode failure (cache state given up, requests
    failed WITH their handoff cursors)."""


class KillAtStep:
    """Deliver ``sig`` to this process the FIRST time the training loop
    completes step ``step`` — a deterministic stand-in for the platform's
    preemption notice. ``_kill`` is injectable for selftests."""

    def __init__(self, step: int, sig: int = signal.SIGTERM, _kill=os.kill):
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        self.step = int(step)
        self.sig = int(sig)
        self.fired = False
        self._kill = _kill

    def fires_at(self, neval: int) -> bool:
        """Would ``on_step(neval)`` fire? (The windowed training loop ends
        a window there, so the kill lands after exactly that step.)"""
        return not self.fired and neval >= self.step

    def on_step(self, neval: int) -> None:
        if self.fires_at(neval):
            self.fired = True
            self._kill(os.getpid(), self.sig)

    def __repr__(self):
        return f"KillAtStep(step={self.step}, sig={self.sig})"


class DelayAtStep:
    """Stall the host for ``seconds`` the first time step ``step``
    completes (straggler / slow-host simulation)."""

    def __init__(self, step: int, seconds: float, _sleep=time.sleep):
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        self.step = int(step)
        self.seconds = float(seconds)
        self.fired = False
        self._sleep = _sleep

    def fires_at(self, neval: int) -> bool:
        return not self.fired and neval >= self.step

    def on_step(self, neval: int) -> None:
        if self.fires_at(neval):
            self.fired = True
            self._sleep(self.seconds)

    def __repr__(self):
        return f"DelayAtStep(step={self.step}, seconds={self.seconds})"


class KillReplicaAfterRequests:
    """Kill the attached serving replica at the first decode-block
    boundary after it has admitted ``n`` requests: raises
    ``ChaosReplicaKill`` inside the worker's decode dispatch, driving
    the REAL die path (cache state given up, in-flight requests failed
    with their handoff cursors). The kill-one-replica drill's trigger."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self.n = int(n)
        self.fired = False

    def on_decode_block(self, server) -> None:
        if not self.fired and server.requests_admitted >= self.n:
            self.fired = True
            raise ChaosReplicaKill(
                f"chaos: replica killed after {self.n} admissions")

    def __repr__(self):
        return f"KillReplicaAfterRequests(n={self.n})"


class DelayDecodeStep:
    """Stall one decode block for ``seconds`` (straggler-replica
    simulation): sleeps inside the worker loop the first time block
    ``block`` starts, delaying every stream on the replica by exactly
    one injected pause."""

    def __init__(self, block: int, seconds: float, _sleep=time.sleep):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)
        self.seconds = float(seconds)
        self.fired = False
        self._sleep = _sleep

    def on_decode_block(self, server) -> None:
        if not self.fired and server.decode_blocks >= self.block:
            self.fired = True
            self._sleep(self.seconds)

    def __repr__(self):
        return f"DelayDecodeStep(block={self.block}, seconds={self.seconds})"


class DropHandoff:
    """Evaporate the router's ``n``-th shipped prefill partition in
    transit (``on_handoff`` returns True exactly once): exercises the
    router's re-ship / local-prefill fallback in the disaggregated
    topology."""

    def __init__(self, n: int = 1):
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self.n = int(n)
        self.seen = 0
        self.fired = False

    def on_handoff(self, router) -> bool:
        self.seen += 1
        if not self.fired and self.seen >= self.n:
            self.fired = True
            return True
        return False

    def __repr__(self):
        return f"DropHandoff(n={self.n})"


def corrupt_snapshot(path: str, mode: str = "flip", seed: int = 0,
                     nbytes: int = 64, shard: int = 0) -> dict:
    """Deterministically damage a plain snapshot file (``model.N`` or
    ``state.N``), or shard file ``shard`` of a sharded snapshot directory
    (the reference's ``corrupt_snapshot``).

    ``mode='flip'``: XOR ``nbytes`` bytes at positions drawn from
    ``default_rng(seed)`` (same seed, same bytes, every time);
    ``'truncate'``: drop the file's second half; ``'delete'``: remove it.
    Returns a description dict (file, mode, positions) for logging."""
    import numpy as np  # heavier import kept out of module load

    if os.path.isdir(path):
        from bigdl_tpu_torch.utils.sharded_checkpoint import read_manifest
        _, shards = read_manifest(path)
        if shards is None:
            shards = sorted(f for f in os.listdir(path)
                            if f.startswith("shard-") and f.endswith(".npz"))
        if not 0 <= shard < len(shards):
            raise ValueError(f"shard {shard} out of range; snapshot has "
                             f"{len(shards)} shard files")
        path = os.path.join(path, shards[shard])
    info = {"file": path, "mode": mode}
    if mode == "delete":
        os.unlink(path)
        return info
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        info["truncated_to"] = size // 2
        return info
    if mode != "flip":
        raise ValueError(f"unknown mode {mode!r}; use flip|truncate|delete")
    rng = np.random.default_rng(seed)
    positions = sorted(int(p) for p in
                       rng.integers(0, max(1, size), size=min(nbytes, size)))
    with open(path, "r+b") as f:
        for pos in positions:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))
    info["positions"] = positions
    return info


def parse_spec(spec: str):
    """One injector from ``kind@step[:arg]``. Training-plane:
    ``kill@5``, ``kill@7:SIGINT``, ``delay@3:0.25``. Serving-plane:
    ``kill-replica@2``, ``delay-decode@3:0.25``, ``drop-handoff@1``."""
    kind, _, rest = spec.strip().partition("@")
    step_s, _, arg = rest.partition(":")
    try:
        step = int(step_s)
    except ValueError:
        raise ValueError(f"bad chaos spec {spec!r}: expected kind@step"
                         f"[:arg]") from None
    if kind == "kill":
        sig = signal.SIGTERM
        if arg:
            name = arg if arg.startswith("SIG") else "SIG" + arg
            sig = getattr(signal, name)
        return KillAtStep(step, sig)
    if kind == "delay":
        return DelayAtStep(step, float(arg or "1.0"))
    if kind == "kill-replica":
        return KillReplicaAfterRequests(step)
    if kind == "delay-decode":
        return DelayDecodeStep(step, float(arg or "1.0"))
    if kind == "drop-handoff":
        return DropHandoff(step)
    raise ValueError(f"unknown chaos injector {kind!r} in {spec!r}")


def from_env(var: str = "BIGDL_CHAOS") -> List["KillAtStep"]:
    """Injectors from a comma-separated env spec (empty -> none) — lets
    launcher-level drills inject faults without touching code."""
    spec = os.environ.get(var, "").strip()
    if not spec:
        return []
    return [parse_spec(s) for s in spec.split(",") if s.strip()]
