"""Module zoo of the port (counterpart of ``bigdl_tpu/nn``): the layers and
criteria the transformer LM slices, the ResNet slice and the classic conv
zoo (LeNet, VGG, Inception, AlexNet) need."""

from bigdl_tpu_torch.nn.attention import (LayerNorm,
                                          LearnedPositionalEncoding,
                                          MultiHeadAttention,
                                          PositionalEncoding, RMSNorm,
                                          TransformerEncoder,
                                          TransformerEncoderLayer,
                                          llama3_scale_freqs, rope_rotate,
                                          scale_rope_freqs)
from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU, Tanh
from bigdl_tpu_torch.nn.containers import (CAddTable, Concat, ConcatTable,
                                           Container, Identity, Sequential)
from bigdl_tpu_torch.nn.conv import (SpaceToDepthConv7, SpatialConvolution,
                                     stem_conv7)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, Criterion,
                                          CrossEntropyCriterion,
                                          FusedLMHeadCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.fused import (FusedConv1x1BN, FusedConv3x3BN,
                                      use_fused_1x1, use_fused_3x3)
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.linear import LMHead, Linear, LookupTable, TiedLMHead
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              SpatialBatchNormalization,
                                              SpatialCrossMapLRN,
                                              blend_running_stats)
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.recurrent import TimeDistributed
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.nn.shape import Padding, Reshape, Transpose

__all__ = ["BatchNormalization", "blend_running_stats", "CAddTable",
           "ClassNLLCriterion", "Concat", "ConcatTable", "Container",
           "Criterion", "CrossEntropyCriterion",
           "Dropout", "FusedConv1x1BN", "FusedConv3x3BN",
           "FusedLMHeadCriterion", "Graph", "Identity", "Input", "LayerNorm",
           "LearnedPositionalEncoding", "Linear", "llama3_scale_freqs", "LMHead",
           "LogSoftMax", "LookupTable", "Module", "MultiHeadAttention", "Node",
           "Padding", "PositionalEncoding", "ReLU", "Reshape", "RMSNorm",
           "rope_rotate", "scale_rope_freqs", "Sequential", "SpaceToDepthConv7",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling",
           "stem_conv7", "Tanh", "TiedLMHead", "TimeDistributed",
           "TimeDistributedCriterion", "TransformerEncoder", "Transpose",
           "TransformerEncoderLayer", "use_fused_1x1", "use_fused_3x3"]
