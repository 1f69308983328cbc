"""scikit-learn-protocol estimators of the port (counterpart of
``bigdl_tpu/ml``): ``DLModel``, ``DLEstimator``, ``DLClassifier``."""

from bigdl_tpu_torch.ml.classifier import DLClassifier, DLEstimator, DLModel

__all__ = ["DLClassifier", "DLEstimator", "DLModel"]
