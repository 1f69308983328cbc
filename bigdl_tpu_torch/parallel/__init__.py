"""The distributed plane (counterpart of ``bigdl_tpu/parallel``):
``MeshTopology`` over a ``torch.distributed`` process group with the data,
tensor and seq axes; ``DistriOptimizer`` (``allreduce``, ``sharded`` ZeRO-1
and ``fsdp`` ZeRO-3, synchronized batch norm, tensor parallelism), the
FSDP layout, the bf16 codec and ``ModelBroadcast``; tensor (Megatron)
parallelism with sequence-parallel regions (``tensor_parallel``) and
context parallelism (``context``: ring and Ulysses attention). The expert
and pipeline axes are ROADMAP A.4's next slice.
"""

from bigdl_tpu_torch.parallel.mesh import MeshTopology
from bigdl_tpu_torch.parallel.context import (
    ring_attention, ulysses_attention, ring_self_attention)
from bigdl_tpu_torch.parallel.tensor_parallel import (
    COLUMN, ROW, infer_param_specs)
from bigdl_tpu_torch.parallel.compression import (
    CompressedTensor, SerializerInstance, fp32_to_bf16, bf16_to_fp32)
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.parallel.fsdp import fsdp_param_specs, shard_fraction
from bigdl_tpu_torch.parallel.model_broadcast import ModelBroadcast

__all__ = ["MeshTopology", "ring_attention", "ulysses_attention",
           "ring_self_attention", "COLUMN", "ROW", "infer_param_specs",
           "CompressedTensor", "SerializerInstance", "fp32_to_bf16",
           "bf16_to_fp32", "DistriOptimizer", "fsdp_param_specs",
           "shard_fraction", "ModelBroadcast"]
