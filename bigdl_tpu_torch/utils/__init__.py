"""Small helpers of the port (counterpart of ``bigdl_tpu/utils``): the
topology ``Engine`` and ``DirectedGraph``, exported as the reference's
``bigdl_tpu/utils/__init__.py`` does. The reference's ``platform.py``
(``ensure_platform``) and ``jax_compat.py`` are JAX plumbing with no
counterpart: the port's device is an explicit argument."""

from bigdl_tpu_torch.utils.digraph import DirectedGraph, Node as DiGraphNode
from bigdl_tpu_torch.utils.engine import Engine
