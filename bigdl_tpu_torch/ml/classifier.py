"""scikit-learn-style wrappers over the port's modules (counterpart of
``bigdl_tpu/ml/classifier.py``): numpy features in, numpy out.

``DLModel.transform`` runs the model's eager forward in eval mode, batch
by batch, on the device the model lives on (the reference jit-compiles
``functional_apply`` and pads the last batch to a static shape; eager
PyTorch needs neither). ``DLEstimator.fit`` trains through ``Optimizer``
on ``device`` (default ``"cuda"``) and returns a ``DLModel``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def _model_device(model: torch.nn.Module) -> torch.device:
    for t in list(model.parameters()) + list(model.buffers()):
        return t.device
    return torch.device("cpu")


class DLModel:
    """A fitted transformer: the batched forward of ``model`` over numpy
    features (reference ``DLModel``)."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 128,
                 feature_shape: Optional[Sequence[int]] = None,
                 log_prob_head: bool = True):
        self.model = model
        self.batch_size = batch_size
        self.feature_shape = tuple(feature_shape) if feature_shape else None
        # the framework's classifier heads end in LogSoftMax; False for a
        # model whose head already gives probabilities
        self.log_prob_head = log_prob_head

    def transform(self, features: np.ndarray) -> np.ndarray:
        """The model's output for every row, in eval mode (the model's
        train/eval mode is restored after)."""
        x = np.asarray(features, dtype=np.float32)
        if self.feature_shape is not None:
            x = x.reshape((-1,) + self.feature_shape)
        dev = _model_device(self.model)
        was_training = self.model.training
        self.model.eval()
        outs = []
        try:
            with torch.no_grad():
                for lo in range(0, x.shape[0], self.batch_size):
                    chunk = torch.from_numpy(x[lo:lo + self.batch_size])
                    outs.append(self.model(chunk.to(dev)))
        finally:
            self.model.train(was_training)
        if not outs:
            return np.zeros((0,))
        return torch.cat(outs).float().cpu().numpy()   # one host transfer

    def predict_proba(self, features: np.ndarray) -> np.ndarray:
        """Probabilities; ``log_prob_head`` fixes the representation."""
        out = self.transform(features)
        return np.exp(out) if self.log_prob_head else out

    def predict(self, features: np.ndarray) -> np.ndarray:
        """1-based class ids, the framework's label convention."""
        return np.argmax(self.transform(features), axis=-1) + 1


class DLEstimator:
    """An unfitted estimator over (model, criterion, optim method): ``fit``
    trains through ``Optimizer`` and returns a ``DLModel`` (reference
    ``DLEstimator``)."""

    def __init__(self, model: torch.nn.Module, criterion,
                 batch_size: int = 128, max_epoch: int = 5,
                 learning_rate: float = 0.01,
                 feature_shape: Optional[Sequence[int]] = None,
                 optim_method=None, log_prob_head: bool = True,
                 device: DeviceLike = "cuda"):
        self.model = model
        self.criterion = criterion
        self.batch_size = batch_size
        self.max_epoch = max_epoch
        self.learning_rate = learning_rate
        self.feature_shape = tuple(feature_shape) if feature_shape else None
        self.optim_method = optim_method
        self.log_prob_head = log_prob_head
        self.device = resolve_device(device)

    def fit(self, features: np.ndarray, labels: np.ndarray) -> DLModel:
        from bigdl_tpu_torch.dataset.base import DataSet, Sample, SampleToBatch
        from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

        x = np.asarray(features, dtype=np.float32)
        if self.feature_shape is not None:
            x = x.reshape((-1,) + self.feature_shape)
        y = np.asarray(labels, dtype=np.float32)
        samples = [Sample(x[i], y[i]) for i in range(x.shape[0])]
        ds = DataSet.array(samples).transform(
            SampleToBatch(batch_size=self.batch_size))
        opt = Optimizer(self.model, ds, self.criterion, device=self.device)
        opt.set_optim_method(self.optim_method
                             or SGD(learningrate=self.learning_rate))
        opt.set_end_when(Trigger.max_epoch(self.max_epoch))
        trained = opt.optimize()
        return DLModel(trained, self.batch_size, self.feature_shape,
                       log_prob_head=self.log_prob_head)


class DLClassifier(DLEstimator):
    """Classification estimator: NLL over log-softmax heads, 1-based
    labels (reference ``DLClassifier``)."""

    def __init__(self, model: torch.nn.Module, criterion=None, **kwargs):
        from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
        super().__init__(model, criterion or ClassNLLCriterion(), **kwargs)
