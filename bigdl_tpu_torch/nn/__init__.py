"""Module zoo of the port (counterpart of ``bigdl_tpu/nn``): the layers the
transformer LM slice needs."""

from bigdl_tpu_torch.nn.attention import (LayerNorm, MultiHeadAttention,
                                          PositionalEncoding, RMSNorm,
                                          TransformerEncoder,
                                          TransformerEncoderLayer,
                                          rope_rotate)
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.linear import LMHead, Linear, LookupTable, TiedLMHead
from bigdl_tpu_torch.nn.module import Module

__all__ = ["LayerNorm", "LMHead", "Linear", "LookupTable", "Module",
           "MultiHeadAttention", "PositionalEncoding", "RMSNorm",
           "Sequential", "TiedLMHead", "TransformerEncoder",
           "TransformerEncoderLayer", "rope_rotate"]
