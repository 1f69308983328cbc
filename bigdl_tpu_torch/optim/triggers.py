"""Training-loop triggers (counterpart of ``bigdl_tpu/optim/triggers.py``).

A trigger is a predicate over the driver state dict (keys ``epoch``,
``neval``, ``trainingLoss``, ``score``), the reference's vocabulary.
"""

from __future__ import annotations

from typing import Callable, Dict


class Trigger:
    """Composable training-state predicate (reference ``Trigger``).

    ``uses_loss`` marks a trigger that reads ``trainingLoss``: the loop then
    fetches each iteration's loss before it checks the trigger.

    ``probe_safe`` marks a trigger that the windowed loop
    (``Optimizer.set_steps_per_dispatch``) may evaluate at simulated later
    ``neval``s of the same epoch to bound a window. A custom ``Trigger(fn)``
    may latch state across calls, so it defaults to False, which forces
    windows of 1; every factory below is safe under same-epoch probing."""

    def __init__(self, fn: Callable[[Dict], bool], name: str = "trigger",
                 uses_loss: bool = False, probe_safe: bool = False):
        self._fn = fn
        self.name = name
        self.uses_loss = uses_loss
        self.probe_safe = probe_safe

    def __call__(self, state: Dict) -> bool:
        return bool(self._fn(state))

    @staticmethod
    def every_epoch() -> "Trigger":
        """Fires at each epoch boundary: when the epoch counter advances
        past the first value seen, so never within the first epoch."""
        box = {"last": None}

        def fn(state) -> bool:
            e = int(state["epoch"])
            if box["last"] is None:
                box["last"] = e
                return False
            if e > box["last"]:
                box["last"] = e
                return True
            return False

        # stateful only on an epoch change: pure under same-epoch probing
        return Trigger(fn, "everyEpoch", probe_safe=True)

    @staticmethod
    def several_iteration(interval: int) -> "Trigger":
        return Trigger(lambda s: int(s["neval"]) % interval == 0,
                       f"severalIteration({interval})", probe_safe=True)

    @staticmethod
    def max_epoch(maximum: int) -> "Trigger":
        return Trigger(lambda s: int(s["epoch"]) > maximum,
                       f"maxEpoch({maximum})", probe_safe=True)

    @staticmethod
    def max_iteration(maximum: int) -> "Trigger":
        return Trigger(lambda s: int(s["neval"]) > maximum,
                       f"maxIteration({maximum})", probe_safe=True)

    @staticmethod
    def max_score(maximum: float) -> "Trigger":
        return Trigger(
            lambda s: float(s.get("score", float("-inf"))) > maximum,
            f"maxScore({maximum})", probe_safe=True)

    @staticmethod
    def min_loss(minimum: float) -> "Trigger":
        return Trigger(
            lambda s: float(s.get("trainingLoss", float("inf"))) < minimum,
            f"minLoss({minimum})", uses_loss=True, probe_safe=True)

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: all(t(s) for t in triggers), "and",
                       uses_loss=any(t.uses_loss for t in triggers),
                       probe_safe=all(t.probe_safe for t in triggers))

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        return Trigger(lambda s: any(t(s) for t in triggers), "or",
                       uses_loss=any(t.uses_loss for t in triggers),
                       probe_safe=all(t.probe_safe for t in triggers))
