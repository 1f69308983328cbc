"""Resilience of the port (counterpart of ``bigdl_tpu/resilience``):

- ``chaos``: the deterministic injectors — the serving plane's
  ``KillReplicaAfterRequests``, ``DelayDecodeStep`` and ``DropHandoff``
  (polled by ``ContinuousLMServer(chaos=...)`` and ``LMRouter(chaos=...)``),
  the training plane's ``KillAtStep`` and ``DelayAtStep``, and the
  ``BIGDL_CHAOS`` spec grammar, and ``corrupt_snapshot``;
- ``preemption``: ``PreemptionHandler``, the SIGTERM flag behind ``serve``'s
  drain and ``Optimizer.set_preemption_handler``, and
  ``TrainingPreempted``, which the training loop raises after its final
  snapshot;
- ``coordinator``: snapshot discovery and validation, the RESUME marker;
- ``serving_drill``: the kill-one-replica fleet drill.
"""

from bigdl_tpu_torch.resilience import chaos, coordinator
from bigdl_tpu_torch.resilience.chaos import (DelayAtStep, DelayDecodeStep,
                                              DropHandoff, KillAtStep,
                                              KillReplicaAfterRequests,
                                              corrupt_snapshot)
from bigdl_tpu_torch.resilience.preemption import (PreemptionHandler,
                                                   TrainingPreempted)

__all__ = ["PreemptionHandler", "TrainingPreempted", "KillAtStep",
           "DelayAtStep", "KillReplicaAfterRequests", "DelayDecodeStep",
           "DropHandoff", "chaos", "coordinator", "corrupt_snapshot"]
