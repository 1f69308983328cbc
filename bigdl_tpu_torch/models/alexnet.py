"""AlexNet (counterpart of ``bigdl_tpu/models/alexnet.py``): the Caffe
BVLC-AlexNet geometry, with grouped convolutions, cross-map LRN and
227x227 BGR input, layers named as in the Caffe deploy definition.

fc6 contracts over Caffe's C, H, W flatten; the port's activations are
NHWC, so ``Transpose([(2, 4), (3, 4)])`` puts them in NCHW order before
the flatten, as in the reference. Parameters are drawn on the CPU from a
generator seeded with ``seed``, then the model moves to ``device``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import SpatialCrossMapLRN
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.nn.shape import Reshape, Transpose
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def build(class_num: int = 1000, has_dropout: bool = True, *,
          device: DeviceLike = "cuda", seed: int = 0) -> Sequential:
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    m = Sequential()
    m.add(SpatialConvolution(3, 96, 11, 11, 4, 4, generator=g)
          .set_name("conv1"))
    m.add(ReLU().set_name("relu1"))
    m.add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1"))
    m.add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"))
    m.add(SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, n_group=2,
                             generator=g).set_name("conv2"))
    m.add(ReLU().set_name("relu2"))
    m.add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm2"))
    m.add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"))
    m.add(SpatialConvolution(256, 384, 3, 3, 1, 1, 1, 1, generator=g)
          .set_name("conv3"))
    m.add(ReLU().set_name("relu3"))
    m.add(SpatialConvolution(384, 384, 3, 3, 1, 1, 1, 1, n_group=2,
                             generator=g).set_name("conv4"))
    m.add(ReLU().set_name("relu4"))
    m.add(SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, n_group=2,
                             generator=g).set_name("conv5"))
    m.add(ReLU().set_name("relu5"))
    m.add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool5"))
    m.add(Transpose([(2, 4), (3, 4)]))
    m.add(Reshape((256 * 6 * 6,), batch_mode=True))
    m.add(Linear(256 * 6 * 6, 4096, generator=g).set_name("fc6"))
    m.add(ReLU().set_name("relu6"))
    if has_dropout:
        m.add(Dropout(0.5).set_name("drop6"))
    m.add(Linear(4096, 4096, generator=g).set_name("fc7"))
    m.add(ReLU().set_name("relu7"))
    if has_dropout:
        m.add(Dropout(0.5).set_name("drop7"))
    m.add(Linear(4096, class_num, generator=g).set_name("fc8"))
    m.add(LogSoftMax())
    return m.to(dev)
