"""Vision Transformer (counterpart of ``bigdl_tpu/models/vit.py``).

``build(class_num)`` is ViT-S/16 (22M parameters): NHWC images (B, H, W,
3) -> a strided ``SpatialConvolution`` patch embedding -> (B, n_patches,
embed_dim) -> learned positions (``CAdd`` over the token grid) -> a
non-causal ``TransformerEncoder`` -> the tokens' mean (``Mean``, 1-based
dimension 2) -> ``Linear`` -> ``LogSoftMax`` (1-based labels,
``ClassNLLCriterion``). On the card the encoder's attention runs kernel K1,
and in training K2/K3 (S = n_patches, D = embed_dim / num_heads).
Parameters are drawn on the CPU from ``seed`` (PyTorch's global generator
is left as it was), then the model moves to ``device``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax
from bigdl_tpu_torch.nn.attention import TransformerEncoder
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.linear import CAdd, Linear
from bigdl_tpu_torch.nn.reduce import Mean
from bigdl_tpu_torch.nn.shape import Reshape
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def build(class_num: int, image_size: int = 224, patch_size: int = 16,
          embed_dim: int = 384, num_heads: int = 6, ffn_dim: int = 1536,
          num_layers: int = 12, dropout: float = 0.0, *,
          device: DeviceLike = "cuda", seed: int = 0) -> Sequential:
    """ViT classifier; the defaults are ViT-S/16."""
    if image_size % patch_size != 0:
        raise ValueError(f"image_size {image_size} must be a multiple of "
                         f"patch_size {patch_size}")
    dev = resolve_device(device)
    n_patches = (image_size // patch_size) ** 2
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = (Sequential()
                 .add(SpatialConvolution(3, embed_dim, patch_size, patch_size,
                                         patch_size, patch_size))
                 .add(Reshape((n_patches, embed_dim), batch_mode=True))
                 .add(CAdd((n_patches, embed_dim)))
                 .add(TransformerEncoder(num_layers, embed_dim, num_heads,
                                         ffn_dim, dropout=dropout,
                                         causal=False))
                 .add(Mean(dimension=2))
                 .add(Linear(embed_dim, class_num))
                 .add(LogSoftMax()))
    return model.to(dev)
