"""Data pipeline of the port (counterpart of ``bigdl_tpu/dataset``)."""

from bigdl_tpu_torch.dataset.device_cache import (CachedSliceBatch,
                                                  DeviceCachedDataSet)

__all__ = ["CachedSliceBatch", "DeviceCachedDataSet"]
