"""Module zoo of the port (counterpart of ``bigdl_tpu/nn``): the layers and
criteria the transformer LM slices and the ResNet slice need."""

from bigdl_tpu_torch.nn.attention import (LayerNorm, MultiHeadAttention,
                                          PositionalEncoding, RMSNorm,
                                          TransformerEncoder,
                                          TransformerEncoderLayer,
                                          rope_rotate)
from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.containers import (CAddTable, ConcatTable, Container,
                                           Identity, Sequential)
from bigdl_tpu_torch.nn.conv import (SpaceToDepthConv7, SpatialConvolution,
                                     stem_conv7)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, Criterion,
                                          FusedLMHeadCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.fused import (FusedConv1x1BN, FusedConv3x3BN,
                                      use_fused_1x1, use_fused_3x3)
from bigdl_tpu_torch.nn.linear import LMHead, Linear, LookupTable, TiedLMHead
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              SpatialBatchNormalization,
                                              blend_running_stats)
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.nn.shape import Padding, Reshape

__all__ = ["BatchNormalization", "blend_running_stats", "CAddTable",
           "ClassNLLCriterion", "ConcatTable", "Container", "Criterion",
           "Dropout", "FusedConv1x1BN", "FusedConv3x3BN",
           "FusedLMHeadCriterion", "Identity", "LayerNorm", "Linear", "LMHead",
           "LogSoftMax", "LookupTable", "Module", "MultiHeadAttention",
           "Padding", "PositionalEncoding", "ReLU", "Reshape", "RMSNorm",
           "rope_rotate", "Sequential", "SpaceToDepthConv7",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialMaxPooling", "stem_conv7",
           "TiedLMHead", "TimeDistributedCriterion", "TransformerEncoder",
           "TransformerEncoderLayer", "use_fused_1x1", "use_fused_3x3"]
