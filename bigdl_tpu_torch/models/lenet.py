"""LeNet-5 on MNIST (counterpart of ``bigdl_tpu/models/lenet.py``):
``build`` as a ``Sequential`` and ``graph``, the same network as a
``Graph``.

Input (N, 28, 28, 1) channels-last (or (N, 784)): conv(1->6, 5x5) -> tanh
-> max pool -> conv(6->12, 5x5) -> tanh -> max pool -> flatten ->
linear(192->100) -> tanh -> linear(100->class_num) -> log-softmax.
Parameters are drawn on the CPU from a generator seeded with ``seed``,
then the model moves to ``device``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax, Tanh
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.graph import Graph, Input
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling
from bigdl_tpu_torch.nn.shape import Reshape
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def build(class_num: int = 10, *, device: DeviceLike = "cuda",
          seed: int = 0) -> Sequential:
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = (Sequential()
             .add(Reshape((28, 28, 1), batch_mode=True))
             .add(SpatialConvolution(1, 6, 5, 5, generator=gen)
                  .set_name("conv1_5x5"))
             .add(Tanh())
             .add(SpatialMaxPooling(2, 2, 2, 2))
             .add(SpatialConvolution(6, 12, 5, 5, generator=gen)
                  .set_name("conv2_5x5"))
             .add(Tanh())
             .add(SpatialMaxPooling(2, 2, 2, 2))
             .add(Reshape((12 * 4 * 4,), batch_mode=True))
             .add(Linear(12 * 4 * 4, 100, generator=gen).set_name("fc_1"))
             .add(Tanh())
             .add(Linear(100, class_num, generator=gen).set_name("fc_2"))
             .add(LogSoftMax()))
    return model.to(dev)


def graph(class_num: int = 10, *, device: DeviceLike = "cuda",
          seed: int = 0) -> Graph:
    """The same network as a ``Graph`` (the DAG path); drawn from ``seed``
    in the same order as ``build``, so both give the same weights."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    inp = Input().inputs()
    x = Reshape((28, 28, 1), batch_mode=True).inputs(inp)
    x = SpatialConvolution(1, 6, 5, 5, generator=gen).inputs(x)
    x = Tanh().inputs(x)
    x = SpatialMaxPooling(2, 2, 2, 2).inputs(x)
    x = SpatialConvolution(6, 12, 5, 5, generator=gen).inputs(x)
    x = Tanh().inputs(x)
    x = SpatialMaxPooling(2, 2, 2, 2).inputs(x)
    x = Reshape((12 * 4 * 4,), batch_mode=True).inputs(x)
    x = Linear(12 * 4 * 4, 100, generator=gen).inputs(x)
    x = Tanh().inputs(x)
    x = Linear(100, class_num, generator=gen).inputs(x)
    out = LogSoftMax().inputs(x)
    return Graph(inp, out).to(dev)
