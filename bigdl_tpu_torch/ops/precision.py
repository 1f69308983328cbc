"""Mixed-precision helpers (counterpart of ``bigdl_tpu/ops/precision.py``;
only ``match_compute`` is ported so far)."""

from __future__ import annotations

import torch


def match_compute(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Cast activation ``x`` to the weight's dtype when the weight's float
    type is narrower, so the matmul runs in the weight's precision; no-op in
    uniform precision and for integer inputs."""
    if (x.dtype != w.dtype and x.is_floating_point() and w.is_floating_point()
            and torch.finfo(w.dtype).bits < torch.finfo(x.dtype).bits):
        return x.to(w.dtype)
    return x
