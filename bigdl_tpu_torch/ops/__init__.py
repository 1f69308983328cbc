"""Attention cores, precision helpers and the CUDA kernels' wrappers
(counterpart of ``bigdl_tpu/ops``). Kernel sources live in ``../csrc``."""

from bigdl_tpu_torch.ops.precision import DtypePolicy, cast_tree, match_compute

__all__ = ["DtypePolicy", "cast_tree", "match_compute"]
