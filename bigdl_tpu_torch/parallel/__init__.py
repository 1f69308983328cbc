"""The distributed plane (counterpart of ``bigdl_tpu/parallel``):
``MeshTopology`` over a ``torch.distributed`` process group with the data,
tensor, pipe, seq and expert axes; ``DistriOptimizer`` (``allreduce``,
``sharded`` ZeRO-1 and ``fsdp`` ZeRO-3, synchronized batch norm, tensor
and expert parallelism, fsdp over a tensor axis), the FSDP layout, the
bf16 codec and ``ModelBroadcast``; tensor (Megatron) parallelism with
sequence-parallel regions (``tensor_parallel``), context parallelism
(``context``: ring and Ulysses attention), the mixture of experts with
global routing (``expert``) and the GPipe and circular pipeline schedules
(``pipeline``).
"""

from bigdl_tpu_torch.parallel.mesh import MeshTopology
from bigdl_tpu_torch.parallel.context import (
    ring_attention, ulysses_attention, ring_self_attention)
from bigdl_tpu_torch.parallel.tensor_parallel import (
    COLUMN, ROW, infer_param_specs)
from bigdl_tpu_torch.parallel.pipeline import (
    PipelineStack, gpipe_loss_fn, pipeline_spec_tree)
from bigdl_tpu_torch.parallel.expert import MoE, expert_param_specs, inject_loss
from bigdl_tpu_torch.parallel.compression import (
    CompressedTensor, SerializerInstance, fp32_to_bf16, bf16_to_fp32)
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.parallel.fsdp import fsdp_param_specs, shard_fraction
from bigdl_tpu_torch.parallel.model_broadcast import ModelBroadcast

__all__ = ["MeshTopology", "ring_attention", "ulysses_attention",
           "ring_self_attention", "COLUMN", "ROW", "infer_param_specs",
           "PipelineStack", "gpipe_loss_fn", "pipeline_spec_tree", "MoE",
           "expert_param_specs", "inject_loss",
           "CompressedTensor", "SerializerInstance", "fp32_to_bf16",
           "bf16_to_fp32", "DistriOptimizer", "fsdp_param_specs",
           "shard_fraction", "ModelBroadcast"]
