"""Inference-path model broadcast (counterpart of
``bigdl_tpu/parallel/model_broadcast.py``, reference
``models/utils/ModelBroadcast.scala:33``).

The reference ships (graph, flat weights) to its Spark tasks once. Here
the weights are copied off the model once and, on a mesh, overwritten with
rank 0's by one ``broadcast`` each: every rank then evaluates the same
weights, and ``predictor`` binds them to a structural copy of the model,
so the caller's module keeps its own (possibly newer) weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from bigdl_tpu_torch.utils.device import module_device


class ModelBroadcast:
    """A model's weights, broadcast from rank 0 of ``mesh`` once."""

    def __init__(self, model: torch.nn.Module, mesh=None):
        self.model = model
        self.mesh = mesh
        with torch.no_grad():
            self.params: Dict[str, torch.Tensor] = {
                n: p.detach().clone() for n, p in model.named_parameters()}
            self.buffers: Dict[str, torch.Tensor] = {
                n: b.detach().clone() for n, b in model.named_buffers()}
            if mesh is not None:
                for t in (*self.params.values(), *self.buffers.values()):
                    mesh.broadcast(t, 0)

    def value(self) -> Tuple[torch.nn.Module, Dict, Dict]:
        """(structure, broadcast parameters, broadcast buffers); the
        structure is shared, not copied."""
        return self.model, self.params, self.buffers

    def predictor(self, batch_size: int = 128):
        """A ``Predictor`` over a structural copy holding the broadcast
        weights, on the model's device."""
        from bigdl_tpu_torch.optim.evaluator import Predictor
        clone = self.model.clone_module()
        with torch.no_grad():
            for n, p in clone.named_parameters():
                p.copy_(self.params[n])
            for n, b in clone.named_buffers():
                b.copy_(self.buffers[n])
        return Predictor(clone, batch_size, device=module_device(clone))
