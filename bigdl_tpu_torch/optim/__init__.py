"""Training loop, optim methods, triggers, validation and evaluation of the
port (counterpart of ``bigdl_tpu/optim``)."""

from bigdl_tpu_torch.optim.methods import (SGD, Adagrad, Adam, AdamW,
                                           CosineDecay, Default,
                                           LearningRateSchedule, MultiStep,
                                           OptimMethod, Poly, Step, Warmup)
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (AccuracyResult, Loss,
                                              LossResult, Perplexity,
                                              PerplexityResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Optimizer,
                                             make_grad_clipper)
from bigdl_tpu_torch.optim.evaluator import Evaluator, Predictor

__all__ = ["AccuracyResult", "Adagrad", "Adam", "AdamW", "CosineDecay",
           "Default", "Evaluator", "LearningRateSchedule", "LocalOptimizer",
           "Loss", "LossResult", "Metrics", "MultiStep", "OptimMethod",
           "Optimizer", "Perplexity", "PerplexityResult", "Poly", "Predictor",
           "SGD", "Step", "Top1Accuracy", "Top5Accuracy", "Trigger",
           "ValidationMethod", "ValidationResult", "Warmup",
           "make_grad_clipper"]
