"""The distributed plane (counterpart of ``bigdl_tpu/parallel``): its data
plane. ``MeshTopology`` over a ``torch.distributed`` process group,
``DistriOptimizer`` (``allreduce``, ``sharded`` ZeRO-1 and ``fsdp``
ZeRO-3, synchronized batch norm), the FSDP layout, the bf16 codec and
``ModelBroadcast``. The model-parallel axes (``tensor_parallel``,
``context``, ``expert``, ``pipeline``) are ROADMAP A.4's next slice.
"""

from bigdl_tpu_torch.parallel.mesh import MeshTopology
from bigdl_tpu_torch.parallel.compression import (
    CompressedTensor, SerializerInstance, fp32_to_bf16, bf16_to_fp32)
from bigdl_tpu_torch.parallel.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.parallel.fsdp import fsdp_param_specs, shard_fraction
from bigdl_tpu_torch.parallel.model_broadcast import ModelBroadcast

__all__ = ["MeshTopology", "CompressedTensor", "SerializerInstance",
           "fp32_to_bf16", "bf16_to_fp32", "DistriOptimizer",
           "fsdp_param_specs", "shard_fraction", "ModelBroadcast"]
