"""VGG for CIFAR-10 (``build``) and VGG-16/19 for ImageNet
(``build_imagenet``), the counterpart of ``bigdl_tpu/models/vgg.py``.
Channels-last input.

Every conv is a stride-1 3x3 conv followed by batch norm and ReLU. Under
the reference's opt-in gate ``BIGDL_TPU_FUSED_3X3`` (read when the model
is built) each pair is one ``FusedConv3x3BN`` (kernel K6 on the card),
kaiming-initialised with a conv bias, as in the reference; without it, a
``SpatialConvolution`` and a ``SpatialBatchNormalization``. Parameters
are drawn on the CPU from a generator seeded with ``seed``, then the
model moves to ``device``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.fused import FusedConv3x3BN, use_fused_3x3
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.nn.shape import Reshape
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

_IMAGENET_CFG = {
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _conv_bn_relu(model, n_in, n_out, gen):
    if use_fused_3x3():
        (model.add(FusedConv3x3BN(n_in, n_out, init_method="kaiming",
                                  with_bias=True, generator=gen))
              .add(ReLU(True)))
        return n_out
    (model.add(SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1,
                                  init_method="kaiming", generator=gen))
          .add(SpatialBatchNormalization(n_out))
          .add(ReLU(True)))
    return n_out


def build(class_num: int = 10, *, device: DeviceLike = "cuda",
          seed: int = 0) -> Sequential:
    """VggForCifar10: (N, 32, 32, 3) -> (N, class_num) log-probabilities;
    its max pools take Torch's ceil output size."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = Sequential()
    n_in = 3
    for block in ([64, 64], [128, 128], [256, 256, 256],
                  [512, 512, 512], [512, 512, 512]):
        for w in block:
            n_in = _conv_bn_relu(model, n_in, w, gen)
        model.add(SpatialMaxPooling(2, 2, 2, 2).ceil())
    (model.add(Reshape((512,), batch_mode=True))
          .add(Linear(512, 512, generator=gen))
          .add(BatchNormalization(512))
          .add(ReLU(True))
          .add(Dropout(0.5))
          .add(Linear(512, class_num, generator=gen))
          .add(LogSoftMax()))
    return model.to(dev)


def build_imagenet(class_num: int = 1000, depth: int = 16, *,
                   device: DeviceLike = "cuda", seed: int = 0) -> Sequential:
    """VGG-16/19: (N, 224, 224, 3) -> (N, class_num) log-probabilities."""
    if depth not in _IMAGENET_CFG:
        raise ValueError(f"unsupported depth {depth}: one of "
                         f"{sorted(_IMAGENET_CFG)}")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = Sequential()
    n_in = 3
    for v in _IMAGENET_CFG[depth]:
        if v == "M":
            model.add(SpatialMaxPooling(2, 2, 2, 2))
        else:
            n_in = _conv_bn_relu(model, n_in, v, gen)
    (model.add(Reshape((512 * 7 * 7,), batch_mode=True))
          .add(Linear(512 * 7 * 7, 4096, generator=gen))
          .add(ReLU(True))
          .add(Dropout(0.5))
          .add(Linear(4096, 4096, generator=gen))
          .add(ReLU(True))
          .add(Dropout(0.5))
          .add(Linear(4096, class_num, generator=gen))
          .add(LogSoftMax()))
    return model.to(dev)
