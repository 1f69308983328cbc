"""Training loop, optim methods and triggers of the port (counterpart of
``bigdl_tpu/optim``)."""

from bigdl_tpu_torch.optim.methods import (SGD, Adagrad, Adam, AdamW,
                                           CosineDecay, Default,
                                           LearningRateSchedule, MultiStep,
                                           OptimMethod, Poly, Step, Warmup)
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Optimizer,
                                             make_grad_clipper)
from bigdl_tpu_torch.optim.triggers import Trigger

__all__ = ["Adagrad", "Adam", "AdamW", "CosineDecay", "Default",
           "LearningRateSchedule", "LocalOptimizer", "MultiStep",
           "OptimMethod", "Optimizer", "Poly", "SGD", "Step", "Trigger",
           "Warmup", "make_grad_clipper"]
