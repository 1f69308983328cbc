"""``Summary``, ``TrainSummary`` and ``ValidationSummary`` (counterpart of
``bigdl_tpu/visualization/summary.py``).

``Optimizer.set_train_summary`` hands a ``TrainSummary`` the ``Loss``,
``Throughput`` and ``LearningRate`` scalars every iteration and, under a
``set_summary_trigger("Parameters", ...)``, each parameter's histogram;
``set_validation_summary`` hands a ``ValidationSummary`` one scalar per
validation method. ``read_scalar`` reads them back.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.visualization.tensorboard import FileReader, FileWriter


class Summary:
    """One event-file writer under ``log_dir/app_name/<suffix>``."""

    _suffix = ""

    def __init__(self, log_dir: str, app_name: str):
        self.log_dir = log_dir
        self.app_name = app_name
        self.folder = os.path.join(log_dir, app_name, self._suffix)
        self._writer: Optional[FileWriter] = None

    @property
    def writer(self) -> FileWriter:
        if self._writer is None:
            self._writer = FileWriter(self.folder)
        return self._writer

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self.writer.add_scalar(tag, value, step)
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self.writer.add_histogram(tag, np.asarray(values), step)
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float, float]]:
        self.close()   # pending events reach the file first
        return FileReader.read_scalar(self.folder, tag)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class TrainSummary(Summary):
    """Training-side summary (reference ``TrainSummary``). ``Parameters``
    histograms are off until ``set_summary_trigger`` names a trigger."""

    _suffix = "train"

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name)
        self._triggers: Dict[str, object] = {}

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        if name not in ("Loss", "Throughput", "LearningRate", "Parameters"):
            raise ValueError(f"unsupported summary tag {name!r}")
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(Summary):
    """Validation-side summary (reference ``ValidationSummary``)."""

    _suffix = "validation"
