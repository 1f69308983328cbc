"""TensorBoard summaries of the port (counterpart of
``bigdl_tpu/visualization``): event files written with no TensorFlow,
the messages encoded by hand (``proto.py``), TFRecord framing with
CRC32C, a queued writer thread and a reader (``tensorboard.py``)."""

from bigdl_tpu_torch.visualization.summary import (Summary, TrainSummary,
                                                   ValidationSummary)
from bigdl_tpu_torch.visualization.tensorboard import (EventWriter,
                                                       FileReader,
                                                       FileWriter,
                                                       RecordWriter)

__all__ = ["Summary", "TrainSummary", "ValidationSummary", "EventWriter",
           "FileWriter", "RecordWriter", "FileReader"]
