"""Module zoo of the port (counterpart of ``bigdl_tpu/nn``): every layer,
container, criterion and regularizer of the reference's ``nn`` package.

The reference's JAX tracing plumbing has no counterpart by design:
``RngStream`` and ``current_rng`` (each random module holds its own
``torch.Generator``), ``functional_apply`` and ``jit_apply``
(``torch.func.functional_call`` of an eager module), and the optimizer's
``make_training_loss_fn`` (``LocalOptimizer``'s step)."""

from bigdl_tpu_torch.nn.attention import (LayerNorm,
                                          LearnedPositionalEncoding,
                                          MultiHeadAttention,
                                          PositionalEncoding, RMSNorm,
                                          TransformerEncoder,
                                          TransformerEncoderLayer,
                                          llama3_scale_freqs, rope_rotate,
                                          scale_rope_freqs)
from bigdl_tpu_torch.nn.activation import (ELU, Abs, AddConstant, Clamp,
                                           Exp, GradientReversal, HardShrink,
                                           HardTanh, LeakyReLU, Log,
                                           LogSigmoid, LogSoftMax,
                                           MulConstant, Power, PReLU, ReLU,
                                           ReLU6, RReLU, Sigmoid, SoftMax,
                                           SoftMin, SoftPlus, SoftShrink,
                                           SoftSign, Sqrt, Square, Tanh,
                                           TanhShrink, Threshold)
from bigdl_tpu_torch.nn.containers import (Bottle, CAddTable, CDivTable,
                                           CMaxTable, CMinTable, CMulTable,
                                           Concat, ConcatTable, Container,
                                           CSubTable, Echo, FlattenTable,
                                           Identity, Index, JoinTable,
                                           MapTable, MaskedSelect,
                                           MixtureTable, NarrowTable,
                                           ParallelTable, SelectTable,
                                           Sequential, SplitTable)
from bigdl_tpu_torch.nn.conv import (SpaceToDepthConv7, SpatialConvolution,
                                     SpatialConvolutionMap,
                                     SpatialDilatedConvolution,
                                     SpatialFullConvolution,
                                     SpatialShareConvolution,
                                     VolumetricConvolution, stem_conv7)
from bigdl_tpu_torch.nn.criterion import (AbsCriterion, BCECriterion,
                                          ClassNLLCriterion,
                                          ClassSimplexCriterion,
                                          CosineEmbeddingCriterion, Criterion,
                                          CriterionTable,
                                          CrossEntropyCriterion,
                                          DiceCoefficientCriterion,
                                          DistKLDivCriterion,
                                          FusedLMHeadCriterion,
                                          HingeEmbeddingCriterion, L1Cost,
                                          L1HingeEmbeddingCriterion,
                                          MarginCriterion,
                                          MarginRankingCriterion,
                                          MSECriterion, MultiCriterion,
                                          MultiLabelMarginCriterion,
                                          MultiLabelSoftMarginCriterion,
                                          MultiMarginCriterion,
                                          ParallelCriterion,
                                          SmoothL1Criterion,
                                          SmoothL1CriterionWithWeights,
                                          SoftMarginCriterion,
                                          SoftmaxWithCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.detection import Nms, nms
from bigdl_tpu_torch.nn.fused import (FusedConv1x1BN, FusedConv3x3BN,
                                      use_fused_1x1, use_fused_3x3)
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.initialization import bilinear_filler
from bigdl_tpu_torch.nn.linear import (MM, MV, Add, Bilinear, CAdd, CMul,
                                       Cosine, DotProduct, Euclidean, LMHead,
                                       Linear, LookupTable, Mul, Scale,
                                       TiedLMHead)
from bigdl_tpu_torch.nn.module import (Module, TensorModule, enable_timing,
                                       named_regularizers)
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, InputNormalize, Normalize, SpatialBatchNormalization,
    SpatialContrastiveNormalization, SpatialCrossMapLRN,
    SpatialDivisiveNormalization, SpatialSubtractiveNormalization,
    VolumetricBatchNormalization, blend_running_stats)
from bigdl_tpu_torch.nn.pooling import (RoiPooling, SpatialAveragePooling,
                                        SpatialMaxPooling,
                                        VolumetricMaxPooling)
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear, QuantizedLMHead,
                                          QuantizedLookupTable,
                                          QuantizedMultiHeadAttention,
                                          QuantizedSpatialConvolution,
                                          QuantizedTiedLMHead, cast_model,
                                          quantize_array, quantize_model,
                                          quantize_module)
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, BiRecurrent, Cell,
                                          LSTMPeephole, Recurrent,
                                          RecurrentDecoder, RnnCell,
                                          TimeDistributed)
from bigdl_tpu_torch.nn.reduce import (CosineDistance, Max, Mean, Min,
                                       PairwiseDistance, Sum)
from bigdl_tpu_torch.nn.regularization import (Dropout, L1L2Regularizer,
                                               L1Penalty, L1Regularizer,
                                               L2Regularizer, Regularizer)
from bigdl_tpu_torch.nn.shape import (Contiguous, InferReshape, Narrow,
                                      Padding, Replicate, Reshape, Reverse,
                                      Select, SpatialZeroPadding, Squeeze,
                                      Transpose, Unsqueeze, View)

__all__ = [
    "Abs", "AbsCriterion", "Add", "AddConstant", "BatchNormalization",
    "BCECriterion", "BiRecurrent", "Bilinear", "bilinear_filler",
    "blend_running_stats", "Bottle", "CAdd", "CAddTable", "CDivTable",
    "Cell", "Clamp", "ClassNLLCriterion", "ClassSimplexCriterion",
    "CMaxTable", "CMinTable", "CMul", "CMulTable", "Concat", "ConcatTable",
    "Container", "Contiguous", "Cosine", "CosineDistance",
    "CosineEmbeddingCriterion", "Criterion", "CriterionTable",
    "CrossEntropyCriterion", "CSubTable", "DiceCoefficientCriterion",
    "DistKLDivCriterion", "DotProduct", "Dropout", "Echo", "ELU",
    "enable_timing", "Euclidean", "Exp", "FlattenTable", "FusedConv1x1BN",
    "FusedConv3x3BN", "FusedLMHeadCriterion", "GradientReversal", "Graph",
    "GRU", "HardShrink", "HardTanh", "HingeEmbeddingCriterion", "Identity",
    "Index", "InferReshape", "Input", "InputNormalize", "JoinTable",
    "L1Cost", "L1HingeEmbeddingCriterion", "L1L2Regularizer", "L1Penalty",
    "L1Regularizer", "L2Regularizer", "LayerNorm", "LeakyReLU",
    "LearnedPositionalEncoding", "Linear", "llama3_scale_freqs", "LMHead",
    "Log", "LogSigmoid", "LogSoftMax", "LookupTable", "LSTM",
    "LSTMPeephole", "MapTable", "MarginCriterion", "MarginRankingCriterion",
    "MaskedSelect", "Max", "Mean", "Min", "MixtureTable", "MM", "Module",
    "MSECriterion", "Mul", "MulConstant", "MultiCriterion",
    "MultiHeadAttention", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion", "MV",
    "named_regularizers", "Narrow", "NarrowTable", "Nms", "nms", "Node",
    "Normalize", "Padding", "PairwiseDistance", "ParallelCriterion",
    "ParallelTable", "PositionalEncoding", "Power", "PReLU",
    "QuantizedLinear", "QuantizedLMHead", "QuantizedLookupTable",
    "QuantizedMultiHeadAttention", "QuantizedSpatialConvolution",
    "QuantizedTiedLMHead", "cast_model", "quantize_array", "quantize_model",
    "quantize_module", "Recurrent",
    "RecurrentDecoder", "Regularizer", "ReLU", "ReLU6", "Replicate",
    "Reshape", "Reverse", "RMSNorm", "RnnCell", "RoiPooling", "rope_rotate",
    "RReLU", "Scale", "scale_rope_freqs", "Select", "SelectTable",
    "Sequential", "Sigmoid", "SmoothL1Criterion",
    "SmoothL1CriterionWithWeights", "SoftMarginCriterion", "SoftMax",
    "SoftmaxWithCriterion", "SoftMin", "SoftPlus", "SoftShrink", "SoftSign",
    "SpaceToDepthConv7", "SpatialAveragePooling",
    "SpatialBatchNormalization", "SpatialContrastiveNormalization",
    "SpatialConvolution", "SpatialConvolutionMap", "SpatialCrossMapLRN",
    "SpatialDilatedConvolution", "SpatialDivisiveNormalization",
    "SpatialFullConvolution", "SpatialMaxPooling", "SpatialShareConvolution",
    "SpatialSubtractiveNormalization", "SpatialZeroPadding", "SplitTable",
    "Sqrt", "Square", "Squeeze", "stem_conv7", "Sum", "Tanh", "TanhShrink",
    "TensorModule", "Threshold", "TiedLMHead", "TimeDistributed",
    "TimeDistributedCriterion", "TransformerEncoder",
    "TransformerEncoderLayer", "Transpose", "Unsqueeze", "use_fused_1x1",
    "use_fused_3x3", "View", "VolumetricBatchNormalization",
    "VolumetricConvolution", "VolumetricMaxPooling"]
