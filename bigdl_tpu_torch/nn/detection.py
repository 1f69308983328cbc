"""Non-maximum suppression (counterpart of ``bigdl_tpu/nn/detection.py``,
reference ``nn/Nms.scala``; used with ``RoiPooling``).

The reference's greedy loop is a fixed-trip ``fori_loop`` with a padded
output, and so is this one: ``max_output`` rounds of tensor operations,
each picking the best live box and suppressing its overlaps. Nothing is
read back to the host inside the loop, so on a card the whole of it is
queued without a synchronization.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bigdl_tpu_torch.nn.module import Module


def _iou(boxes: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """IoU of every row of ``boxes`` (N, 4 xyxy) against ``box`` (4,)."""
    x1 = torch.maximum(boxes[:, 0], box[0])
    y1 = torch.maximum(boxes[:, 1], box[1])
    x2 = torch.minimum(boxes[:, 2], box[2])
    y2 = torch.minimum(boxes[:, 3], box[3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_b = (box[2] - box[0]) * (box[3] - box[1])
    return inter / (area + area_b - inter).clamp_min(1e-10)


def nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float,
        max_output: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS (reference ``nms``): ``(indices, count)``, ``indices``
    (max_output,) int32, 0-based into ``boxes``, padded with -1; ``count``
    a 0-dim int32 tensor of the boxes kept. Each round keeps the
    highest-scoring live box (the first on a tie) and retires it and
    every box whose IoU with it exceeds ``threshold``; a non-finite score
    is never kept."""
    boxes = boxes.to(torch.float32)
    live = scores.to(torch.float32)
    live = torch.where(torch.isfinite(live), live, float("-inf"))
    dev = live.device
    ids = torch.arange(live.shape[0], device=dev)
    out = torch.full((max_output,), -1, dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(max_output):
        best = torch.argmax(live)
        # index_select, not live[best]: indexing by a 0-dim tensor reads
        # it back to the host
        pick = best.reshape(1)
        valid = live.index_select(0, pick)[0] > float("-inf")
        suppress = ((_iou(boxes, boxes.index_select(0, pick)[0]) > threshold)
                    | (ids == best))
        live = torch.where(valid & suppress, float("-inf"), live)
        out[i] = torch.where(valid, best, -1)
        count = count + valid.to(torch.int32)
    return out.to(torch.int32), count


class Nms(Module):
    """Module face of ``nms`` (reference ``Nms``): ``forward(boxes,
    scores)`` gives the kept indices 1-based, padded with 0."""

    def __init__(self, threshold: float = 0.7, max_output: int = 100):
        super().__init__()
        self.threshold = threshold
        self.max_output = max_output

    def forward(self, boxes, scores):
        idx, _ = nms(torch.as_tensor(boxes), torch.as_tensor(scores),
                     self.threshold, self.max_output)
        return torch.where(idx >= 0, idx + 1, 0)
