"""Attention cores, precision helpers and the CUDA kernels' wrappers
(counterpart of ``bigdl_tpu/ops``). Kernel sources live in ``../csrc``."""
