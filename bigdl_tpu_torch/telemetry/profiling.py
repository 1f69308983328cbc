"""Device-memory sampling (counterpart of ``bigdl_tpu/telemetry/profiling.py``;
only ``sample_device_memory`` is ported).

The reference's compile flight recorder (``tracked_jit``, one event per XLA
program build) has no port yet (ROADMAP A.5). The port's programs are the
continuous engine's CUDA graphs (``utils/cuda_graph.py``): each capture
counts in ``bigdl_serving_recompiles_total`` at the reference's sites
``serving.step`` and ``serving.spec_step``.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.telemetry.registry import MetricsRegistry, get_registry

__all__ = ["sample_device_memory"]


def sample_device_memory(registry: Optional[MetricsRegistry],
                         device) -> Optional[int]:
    """Sample the allocator of ``device`` into the
    ``bigdl_device_memory_bytes`` / ``_peak_bytes`` gauges of ``registry``
    (default the global one) and return the peak; ``None`` for a CPU
    device, which has no allocator statistics. The serving engine calls it
    at each admission and each decode round with its own device. On a CUDA
    device a failure raises: it is never taken for "no statistics"."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    in_use = torch.cuda.memory_allocated(device)
    peak = torch.cuda.max_memory_allocated(device)
    from bigdl_tpu_torch.telemetry.catalogue import instruments
    tm = instruments(registry if registry is not None else get_registry())
    tm.device_memory_bytes.set(in_use)
    tm.device_memory_peak_bytes.set(peak)
    return peak
