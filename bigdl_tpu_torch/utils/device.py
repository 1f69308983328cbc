"""Device selection for the port's entry points.

No counterpart in ``bigdl_tpu`` (JAX picks its backend globally). Every entry
point of the port takes ``device`` and resolves it here: the card by default,
the CPU only when the caller asks for it. There is no silent fallback.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent, and for any device type other than ``cuda`` and ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bigdl_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: 'cuda' or 'cpu'")


def module_device(module: torch.nn.Module) -> torch.device:
    """Device of a module's first parameter or buffer."""
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    raise ValueError(f"{type(module).__name__} holds no tensors")


def check_module_device(module: torch.nn.Module, device: DeviceLike) -> torch.device:
    """Resolve ``device`` and check that ``module`` lives there."""
    dev = resolve_device(device)
    have = module_device(module)
    if have.type != dev.type or (dev.type == "cuda" and have.index != dev.index):
        raise ValueError(f"model is on {have}, but device={str(dev)!r} was "
                         "asked for; move the model or pass its device")
    return dev
