"""MNIST autoencoder (counterpart of ``bigdl_tpu/models/autoencoder.py``):
784 -> class_num -> 784, ReLU then Sigmoid, trained with MSE against its
own input. Parameters are drawn on the CPU from a generator seeded with
``seed``, then the model moves to ``device``."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.activation import ReLU, Sigmoid
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.shape import Reshape
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def build(class_num: int = 32, *, device: DeviceLike = "cuda",
          seed: int = 0) -> Sequential:
    """``class_num`` is the bottleneck width, the reference's argument."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = (Sequential()
             .add(Reshape((784,), batch_mode=True))
             .add(Linear(784, class_num, generator=gen))
             .add(ReLU(True))
             .add(Linear(class_num, 784, generator=gen))
             .add(Sigmoid()))
    return model.to(dev)
