"""Data pipeline of the port (counterpart of ``bigdl_tpu/dataset``)."""

from bigdl_tpu_torch.dataset.base import (AbstractDataSet, BucketBatch,
                                          ByteRecord, ChainedTransformer,
                                          DataSet, LocalDataSet, MiniBatch,
                                          MTTransformer, Prefetch, Sample,
                                          SampleToBatch, Transformer)
from bigdl_tpu_torch.dataset.base import Identity as IdentityTransformer
from bigdl_tpu_torch.dataset.bpe import BPETokenizer
from bigdl_tpu_torch.dataset.device_cache import (CachedSliceBatch,
                                                  DeviceCachedDataSet)
from bigdl_tpu_torch.dataset import text
from bigdl_tpu_torch.dataset.ingest import (IngestConfig, IngestEngine,
                                            PrefetchingDataSet)

__all__ = ["AbstractDataSet", "BPETokenizer", "BucketBatch", "ByteRecord",
           "CachedSliceBatch", "ChainedTransformer", "DataSet",
           "DeviceCachedDataSet", "IdentityTransformer", "IngestConfig",
           "IngestEngine", "LocalDataSet", "PrefetchingDataSet",
           "MTTransformer", "MiniBatch", "Prefetch", "Sample",
           "SampleToBatch", "Transformer", "text"]
