"""Training loop, optim methods, triggers, validation and evaluation of the
port (counterpart of ``bigdl_tpu/optim``)."""

from bigdl_tpu_torch.optim.methods import (SGD, Adagrad, Adam, AdamW,
                                           CosineDecay, Default,
                                           EpochSchedule,
                                           LearningRateSchedule, MultiStep,
                                           OptimMethod, Poly, Regime, Step,
                                           Warmup)
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
from bigdl_tpu_torch.optim.validator import (DistriValidator, LocalValidator,
                                             Validator, calc_accuracy,
                                             calc_top5_accuracy)

__all__ = ["AccuracyResult", "Adagrad", "Adam", "AdamW", "calc_accuracy",
           "calc_top5_accuracy", "CosineDecay", "Default", "DistriValidator",
           "EpochSchedule", "Evaluator", "LearningRateSchedule",
           "LocalOptimizer", "LocalValidator", "Loss", "LossResult",
           "Metrics", "MultiStep", "OptimMethod", "Optimizer", "Perplexity",
           "PerplexityResult", "Poly", "Predictor", "Regime", "SGD", "Step",
           "Top1Accuracy", "Top5Accuracy", "Trigger", "ValidationMethod",
           "ValidationResult", "Validator", "Warmup", "make_grad_clipper"]
