"""The Torch-style tensor of the port (counterpart of
``bigdl_tpu/tensor``): ``Tensor`` and ``Storage`` with the reference's
1-based API over a ``torch.Tensor``, views sharing storage as Torch's
do."""

from bigdl_tpu_torch.tensor.tensor import Storage, Tensor

__all__ = ["Tensor", "Storage"]
