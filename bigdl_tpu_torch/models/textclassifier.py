"""The GloVe + CNN text classifier (counterpart of
``bigdl_tpu/models/textclassifier.py``).

Input (N, T, E): pre-embedded tokens, viewed channels-last as (N, T, 1, E)
with time as the spatial H axis, so each convolution contracts the
embedding. Three stages of conv(k=5) -> ReLU -> max pool (the first two
k=5 s=5, the last over whatever time is left), then linear(128 -> 100) ->
linear(100 -> class_num) -> log-softmax. Parameters are drawn on the CPU
from a generator seeded with ``seed``, then the model moves to ``device``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling
from bigdl_tpu_torch.nn.shape import Reshape
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def conv_output_length(sequence_length: int) -> int:
    """Time extent left after the conv5/pool5 x2 + conv5 stages."""
    h = sequence_length - 4      # conv k=5
    h = h // 5                   # pool k=5 s=5
    h = h - 4                    # conv k=5
    h = h // 5                   # pool k=5 s=5
    h = h - 4                    # conv k=5
    return h


def build_cnn(class_num: int, sequence_length: int = 1000,
              embedding_dim: int = 100, *, device: DeviceLike = "cuda",
              seed: int = 0) -> Sequential:
    """The reference's geometry (T=1000 ends in a 35-wide pool); shorter
    sequences (down to 149) collapse to 1 the same way."""
    last = conv_output_length(sequence_length)
    if last < 1:
        raise ValueError(
            f"sequence_length {sequence_length} too short for the "
            f"conv5/pool5 x3 stack (needs >= 149)")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = (Sequential()
             .add(Reshape((sequence_length, 1, embedding_dim),
                          batch_mode=True))
             .add(SpatialConvolution(embedding_dim, 128, 1, 5, generator=gen))
             .add(ReLU())
             .add(SpatialMaxPooling(1, 5))
             .add(SpatialConvolution(128, 128, 1, 5, generator=gen))
             .add(ReLU())
             .add(SpatialMaxPooling(1, 5))
             .add(SpatialConvolution(128, 128, 1, 5, generator=gen))
             .add(ReLU())
             .add(SpatialMaxPooling(1, last))
             .add(Reshape((128,), batch_mode=True))
             .add(Linear(128, 100, generator=gen))
             .add(Linear(100, class_num, generator=gen))
             .add(LogSoftMax()))
    return model.to(dev)
