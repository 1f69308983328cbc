"""ResNet (counterpart of ``bigdl_tpu/models/resnet.py``): the ImageNet
bottleneck and basic-block variants (depth 18, 34, 50, 101, 152) and the
CIFAR basic-block variants (depth 6n + 2), built from the container zoo as
the reference builds them (``Sequential`` + ``ConcatTable(main, shortcut)``
+ ``CAddTable`` + ``ReLU``), channels-last, kaiming-initialised convs, BN
gamma 1 and beta 0.

Conv+BN pairs collapse into ``FusedConv1x1BN`` (every 1x1 pair) under
``BIGDL_TPU_FUSED_1X1=1`` and into ``FusedConv3x3BN`` (every stride-1 3x3
pair) under ``BIGDL_TPU_FUSED_3X3=1``, the reference's opt-in gates, read
when the model is built. The fused modules name their parameters
differently from an unfused model's (``chip_smoke.py``'s ``transfer_state``
maps one onto the other by walking the conv+BN pairs in order).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.containers import (CAddTable, ConcatTable, Identity,
                                           Sequential)
from bigdl_tpu_torch.nn.conv import SpatialConvolution, stem_conv7
from bigdl_tpu_torch.nn.fused import (FusedConv1x1BN, FusedConv3x3BN,
                                      use_fused_1x1, use_fused_3x3)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.shape import Padding, Reshape
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

_IMAGENET_CFG = {
    18: ([2, 2, 2, 2], "basic"),
    34: ([3, 4, 6, 3], "basic"),
    50: ([3, 4, 6, 3], "bottleneck"),
    101: ([3, 4, 23, 3], "bottleneck"),
    152: ([3, 8, 36, 3], "bottleneck"),
}


def _add_conv_bn(seq, n_in, n_out, k, stride, pad, gen):
    """A conv+BN pair appended to ``seq``: fused behind the gates, else a
    ``SpatialConvolution`` and a ``SpatialBatchNormalization``."""
    if k == 1 and pad == 0 and use_fused_1x1():
        return seq.add(FusedConv1x1BN(n_in, n_out, stride, generator=gen))
    if k == 3 and pad == 1 and stride == 1 and use_fused_3x3():
        return seq.add(FusedConv3x3BN(n_in, n_out, generator=gen))
    return (seq.add(SpatialConvolution(n_in, n_out, k, k, stride, stride,
                                       pad, pad, with_bias=False,
                                       init_method="kaiming", generator=gen))
            .add(SpatialBatchNormalization(n_out)))


def _shortcut(n_in, n_out, stride, shortcut_type, gen):
    if n_in != n_out or stride != 1:
        if shortcut_type == "A":
            # identity subsampled by a 1x1 average pool, channels zero-padded
            return (Sequential()
                    .add(SpatialAveragePooling(1, 1, stride, stride))
                    .add(Padding(3, n_out - n_in, 3)))
        return _add_conv_bn(Sequential(), n_in, n_out, 1, stride, 0, gen)
    return Identity()


def _residual(main, shortcut):
    return (Sequential().add(ConcatTable().add(main).add(shortcut))
            .add(CAddTable()).add(ReLU()))


def _basic_block(n_in, n_out, stride, shortcut_type, gen):
    main = _add_conv_bn(Sequential(), n_in, n_out, 3, stride, 1, gen)
    main.add(ReLU())
    _add_conv_bn(main, n_out, n_out, 3, 1, 1, gen)
    return _residual(main, _shortcut(n_in, n_out, stride, shortcut_type, gen))


def _bottleneck(n_in, n_mid, stride, shortcut_type, gen):
    n_out = n_mid * 4
    main = _add_conv_bn(Sequential(), n_in, n_mid, 1, 1, 0, gen)
    main.add(ReLU())
    _add_conv_bn(main, n_mid, n_mid, 3, stride, 1, gen)
    main.add(ReLU())
    _add_conv_bn(main, n_mid, n_out, 1, 1, 0, gen)
    return _residual(main, _shortcut(n_in, n_out, stride, shortcut_type, gen))


def build(class_num: int = 1000, depth: int = 50, shortcut_type: str = "B",
          *, device: DeviceLike = "cuda", seed: int = 0) -> Sequential:
    """ImageNet ResNet: (N, 224, 224, 3) NHWC images -> (N, class_num)
    log-probabilities. The stem is ``stem_conv7`` (space-to-depth unless
    ``BIGDL_TPU_NO_S2D`` is set), BN, ReLU and a 3x3/s2 max pool; the head
    a 7x7 average pool, ``Reshape``, ``Linear`` and ``LogSoftMax``.
    Parameters are drawn on the CPU from a generator seeded with ``seed``,
    then the model moves to ``device``."""
    if depth not in _IMAGENET_CFG:
        raise ValueError(f"unsupported depth {depth}: one of "
                         f"{sorted(_IMAGENET_CFG)}")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    layers, block_kind = _IMAGENET_CFG[depth]
    model = (Sequential()
             .add(stem_conv7(3, 64, with_bias=False, init_method="kaiming",
                             generator=gen))
             .add(SpatialBatchNormalization(64))
             .add(ReLU())
             .add(SpatialMaxPooling(3, 3, 2, 2, 1, 1)))
    n_in = 64
    for stage, (width, reps) in enumerate(zip([64, 128, 256, 512], layers)):
        for i in range(reps):
            stride = 2 if (stage > 0 and i == 0) else 1
            if block_kind == "bottleneck":
                model.add(_bottleneck(n_in, width, stride, shortcut_type, gen))
                n_in = width * 4
            else:
                model.add(_basic_block(n_in, width, stride, shortcut_type,
                                       gen))
                n_in = width
    model.add(SpatialAveragePooling(7, 7, 1, 1))
    model.add(Reshape((n_in,), batch_mode=True))
    model.add(Linear(n_in, class_num, generator=gen))
    model.add(LogSoftMax())
    return model.to(dev)


def build_cifar(class_num: int = 10, depth: int = 20,
                shortcut_type: str = "A", *, device: DeviceLike = "cuda",
                seed: int = 0) -> Sequential:
    """CIFAR ResNet (depth = 6n + 2; the reference's CIFAR config uses
    shortcut A): (N, 32, 32, 3) -> (N, class_num) log-probabilities."""
    if (depth - 2) % 6:
        raise ValueError(f"CIFAR ResNet depth must be 6n + 2, got {depth}")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    n = (depth - 2) // 6
    model = _add_conv_bn(Sequential(), 3, 16, 3, 1, 1, gen)
    model.add(ReLU())
    n_in = 16
    for stage, width in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            model.add(_basic_block(n_in, width, stride, shortcut_type, gen))
            n_in = width
    model.add(SpatialAveragePooling(8, 8, 1, 1))
    model.add(Reshape((64,), batch_mode=True))
    model.add(Linear(64, class_num, generator=gen))
    model.add(LogSoftMax())
    return model.to(dev)
