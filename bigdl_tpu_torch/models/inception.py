"""Inception v1 / GoogLeNet (``build``) and Inception v2 / BN-Inception
(``build_v2``), the counterpart of ``bigdl_tpu/models/inception.py``,
built as the reference builds them: blocks of parallel branches in a
``Concat`` on the channels, layers named as in the reference, input
(N, 224, 224, 3) channels-last, no auxiliary classifiers.

In v2 every conv is followed by batch norm (eps 1e-3) and ReLU. Under the
reference's opt-in gates, read when the model is built, the 1x1 pairs are
``FusedConv1x1BN`` (``BIGDL_TPU_FUSED_1X1``; kernel K5 on the card) and
the stride-1 3x3 pairs ``FusedConv3x3BN`` (``BIGDL_TPU_FUSED_3X3``; K6),
each with a conv bias as the unfused conv has; the reduction blocks'
stride-2 3x3 convs stay unfused, as in the reference. The stems are
``stem_conv7``. Parameters are drawn on the CPU from a generator seeded
with ``seed``, then the model moves to ``device``; the block builders
take the generator.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.containers import Concat, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution, stem_conv7
from bigdl_tpu_torch.nn.fused import (FusedConv1x1BN, FusedConv3x3BN,
                                      use_fused_1x1, use_fused_3x3)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import (SpatialBatchNormalization,
                                              SpatialCrossMapLRN)
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.nn.shape import Reshape
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

Gen = Optional[torch.Generator]


def _conv(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0, name="", gen=None):
    return (Sequential()
            .add(SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph,
                                    init_method="xavier", generator=gen)
                 .set_name(name + "conv"))
            .add(ReLU(True)))


def inception_module(n_in, c1x1, c3x3r, c3x3, c5x5r, c5x5, pool_proj,
                     name="inception", gen: Gen = None) -> Concat:
    """One v1 block: 1x1, 3x3, 5x5 and pool branches concatenated on the
    channels."""
    concat = Concat(1).set_name(name)
    concat.add(_conv(n_in, c1x1, 1, 1, name=f"{name}/1x1/", gen=gen))
    concat.add(Sequential()
               .add(_conv(n_in, c3x3r, 1, 1, name=f"{name}/3x3r/", gen=gen))
               .add(_conv(c3x3r, c3x3, 3, 3, 1, 1, 1, 1,
                          name=f"{name}/3x3/", gen=gen)))
    concat.add(Sequential()
               .add(_conv(n_in, c5x5r, 1, 1, name=f"{name}/5x5r/", gen=gen))
               .add(_conv(c5x5r, c5x5, 5, 5, 1, 1, 2, 2,
                          name=f"{name}/5x5/", gen=gen)))
    concat.add(Sequential()
               .add(SpatialMaxPooling(3, 3, 1, 1, 1, 1))
               .add(_conv(n_in, pool_proj, 1, 1, name=f"{name}/pool_proj/",
                          gen=gen)))
    return concat


def build(class_num: int = 1000, *, device: DeviceLike = "cuda",
          seed: int = 0) -> Sequential:
    """Inception v1's main tower (the reference's
    ``Inception_v1_NoAuxClassifier``)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = (Sequential()
             .add(stem_conv7(3, 64, init_method="xavier",
                             name="conv1/7x7_s2", generator=g))
             .add(ReLU(True))
             .add(SpatialMaxPooling(3, 3, 2, 2).ceil())
             .add(SpatialCrossMapLRN(5, 0.0001, 0.75))
             .add(_conv(64, 64, 1, 1, name="conv2/3x3_reduce/", gen=g))
             .add(_conv(64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3/", gen=g))
             .add(SpatialCrossMapLRN(5, 0.0001, 0.75))
             .add(SpatialMaxPooling(3, 3, 2, 2).ceil())
             .add(inception_module(192, 64, 96, 128, 16, 32, 32,
                                   "inception_3a", g))
             .add(inception_module(256, 128, 128, 192, 32, 96, 64,
                                   "inception_3b", g))
             .add(SpatialMaxPooling(3, 3, 2, 2).ceil())
             .add(inception_module(480, 192, 96, 208, 16, 48, 64,
                                   "inception_4a", g))
             .add(inception_module(512, 160, 112, 224, 24, 64, 64,
                                   "inception_4b", g))
             .add(inception_module(512, 128, 128, 256, 24, 64, 64,
                                   "inception_4c", g))
             .add(inception_module(512, 112, 144, 288, 32, 64, 64,
                                   "inception_4d", g))
             .add(inception_module(528, 256, 160, 320, 32, 128, 128,
                                   "inception_4e", g))
             .add(SpatialMaxPooling(3, 3, 2, 2).ceil())
             .add(inception_module(832, 256, 160, 320, 32, 128, 128,
                                   "inception_5a", g))
             .add(inception_module(832, 384, 192, 384, 48, 128, 128,
                                   "inception_5b", g))
             .add(SpatialAveragePooling(7, 7, 1, 1))
             .add(Dropout(0.4))
             .add(Reshape((1024,), batch_mode=True))
             .add(Linear(1024, class_num, generator=g)
                  .set_name("loss3/classifier"))
             .add(LogSoftMax()))
    return model.to(dev)


def _conv_bn(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0, name="",
             gen: Gen = None) -> Sequential:
    """conv -> BN(eps=1e-3) -> ReLU, Inception v2's unit; fused behind the
    gates (see the module docstring)."""
    if (kw, kh, pw, ph) == (1, 1, 0, 0) and sw == sh and use_fused_1x1():
        return (Sequential()
                .add(FusedConv1x1BN(n_in, n_out, sw, eps=1e-3,
                                    init_method="xavier", with_bias=True,
                                    generator=gen).set_name(name))
                .add(ReLU(True)))
    if (kw, kh, pw, ph, sw, sh) == (3, 3, 1, 1, 1, 1) and use_fused_3x3():
        return (Sequential()
                .add(FusedConv3x3BN(n_in, n_out, eps=1e-3,
                                    init_method="xavier", with_bias=True,
                                    generator=gen).set_name(name))
                .add(ReLU(True)))
    if (kw, kh, sw, sh, pw, ph) == (7, 7, 2, 2, 3, 3):
        return (Sequential()
                .add(stem_conv7(n_in, n_out, init_method="xavier", name=name,
                                generator=gen))
                .add(SpatialBatchNormalization(n_out, 1e-3)
                     .set_name(name + "/bn"))
                .add(ReLU(True)))
    return (Sequential()
            .add(SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph,
                                    init_method="xavier", generator=gen)
                 .set_name(name))
            .add(SpatialBatchNormalization(n_out, 1e-3)
                 .set_name(name + "/bn"))
            .add(ReLU(True)))


def inception_module_v2(n_in, c1x1, c3x3r, c3x3, cd3x3r, cd3x3, pool_mode,
                        pool_proj, name="inception",
                        gen: Gen = None) -> Concat:
    """One BN-Inception block: 1x1 / 3x3 / double-3x3 / pool branches.
    ``c1x1 == 0`` drops the 1x1 branch and makes the 3x3 and double-3x3
    tails stride 2 (the grid reductions 3c and 4e); ``pool_mode`` is "avg"
    or "max", and ``pool_proj == 0`` means a stride-2 max pool and no
    projection."""
    reduction = c1x1 == 0
    stride = 2 if reduction else 1
    concat = Concat(1).set_name(name)
    if not reduction:
        concat.add(_conv_bn(n_in, c1x1, 1, 1, name=f"{name}/1x1", gen=gen))
    concat.add(Sequential()
               .add(_conv_bn(n_in, c3x3r, 1, 1, name=f"{name}/3x3_reduce",
                             gen=gen))
               .add(_conv_bn(c3x3r, c3x3, 3, 3, stride, stride, 1, 1,
                             name=f"{name}/3x3", gen=gen)))
    concat.add(Sequential()
               .add(_conv_bn(n_in, cd3x3r, 1, 1,
                             name=f"{name}/double3x3_reduce", gen=gen))
               .add(_conv_bn(cd3x3r, cd3x3, 3, 3, 1, 1, 1, 1,
                             name=f"{name}/double3x3a", gen=gen))
               .add(_conv_bn(cd3x3, cd3x3, 3, 3, stride, stride, 1, 1,
                             name=f"{name}/double3x3b", gen=gen)))
    pool = Sequential()
    if pool_mode == "avg":
        pool.add(SpatialAveragePooling(3, 3, 1, 1, 1, 1).ceil())
    elif pool_proj != 0:
        pool.add(SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
    else:
        pool.add(SpatialMaxPooling(3, 3, 2, 2).ceil())
    if pool_proj != 0:
        pool.add(_conv_bn(n_in, pool_proj, 1, 1, name=f"{name}/pool_proj",
                          gen=gen))
    concat.add(pool)
    return concat


def build_v2(class_num: int = 1000, *, device: DeviceLike = "cuda",
             seed: int = 0) -> Sequential:
    """Inception v2 / BN-Inception's main tower (the reference's
    ``Inception_v2_NoAuxClassifier``)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = (Sequential()
             .add(_conv_bn(3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2",
                           gen=g))
             .add(SpatialMaxPooling(3, 3, 2, 2).ceil())
             .add(_conv_bn(64, 64, 1, 1, name="conv2/3x3_reduce", gen=g))
             .add(_conv_bn(64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3",
                           gen=g))
             .add(SpatialMaxPooling(3, 3, 2, 2).ceil())
             .add(inception_module_v2(192, 64, 64, 64, 64, 96, "avg", 32,
                                      "inception_3a", g))
             .add(inception_module_v2(256, 64, 64, 96, 64, 96, "avg", 64,
                                      "inception_3b", g))
             .add(inception_module_v2(320, 0, 128, 160, 64, 96, "max", 0,
                                      "inception_3c", g))
             .add(inception_module_v2(576, 224, 64, 96, 96, 128, "avg", 128,
                                      "inception_4a", g))
             .add(inception_module_v2(576, 192, 96, 128, 96, 128, "avg", 128,
                                      "inception_4b", g))
             .add(inception_module_v2(576, 160, 128, 160, 128, 160, "avg", 96,
                                      "inception_4c", g))
             .add(inception_module_v2(576, 96, 128, 192, 160, 192, "avg", 96,
                                      "inception_4d", g))
             .add(inception_module_v2(576, 0, 128, 192, 192, 256, "max", 0,
                                      "inception_4e", g))
             .add(inception_module_v2(1024, 352, 192, 320, 160, 224, "avg",
                                      128, "inception_5a", g))
             .add(inception_module_v2(1024, 352, 192, 320, 192, 224, "max",
                                      128, "inception_5b", g))
             .add(SpatialAveragePooling(7, 7, 1, 1).ceil())
             .add(Reshape((1024,), batch_mode=True))
             .add(Linear(1024, class_num, generator=g)
                  .set_name("loss3/classifier"))
             .add(LogSoftMax()))
    return model.to(dev)
