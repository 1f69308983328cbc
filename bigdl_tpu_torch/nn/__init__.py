"""Module zoo of the port (counterpart of ``bigdl_tpu/nn``): the layers and
criteria the transformer LM slices need."""

from bigdl_tpu_torch.nn.attention import (LayerNorm, MultiHeadAttention,
                                          PositionalEncoding, RMSNorm,
                                          TransformerEncoder,
                                          TransformerEncoderLayer,
                                          rope_rotate)
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, Criterion,
                                          FusedLMHeadCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.linear import LMHead, Linear, LookupTable, TiedLMHead
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.regularization import Dropout

__all__ = ["ClassNLLCriterion", "Criterion", "Dropout",
           "FusedLMHeadCriterion", "LayerNorm", "LMHead", "Linear",
           "LookupTable", "Module", "MultiHeadAttention",
           "PositionalEncoding", "RMSNorm", "Sequential", "TiedLMHead",
           "TimeDistributedCriterion", "TransformerEncoder",
           "TransformerEncoderLayer", "rope_rotate"]
