"""Resilience of the port (counterpart of ``bigdl_tpu/resilience``):

- ``chaos``: the deterministic injectors — the serving plane's
  ``KillReplicaAfterRequests``, ``DelayDecodeStep`` and ``DropHandoff``
  (polled by ``ContinuousLMServer(chaos=...)`` and ``LMRouter(chaos=...)``),
  the training plane's ``KillAtStep`` and ``DelayAtStep``, and the
  ``BIGDL_CHAOS`` spec grammar;
- ``preemption``: ``PreemptionHandler``, the SIGTERM flag behind ``serve``'s
  drain;
- ``serving_drill``: the kill-one-replica fleet drill.

The coordinator, snapshots and ``corrupt_snapshot`` wait for the checkpoint
port (ROADMAP A.5).
"""

from bigdl_tpu_torch.resilience import chaos
from bigdl_tpu_torch.resilience.chaos import (DelayAtStep, DelayDecodeStep,
                                              DropHandoff, KillAtStep,
                                              KillReplicaAfterRequests)
from bigdl_tpu_torch.resilience.preemption import (PreemptionHandler,
                                                   TrainingPreempted)

__all__ = ["PreemptionHandler", "TrainingPreempted", "KillAtStep",
           "DelayAtStep", "KillReplicaAfterRequests", "DelayDecodeStep",
           "DropHandoff", "chaos"]
