"""The module surface on the CIFAR ResNet-8 at 32x32 in training mode,
the port against the JAX package on the CPU: its summary, count and flat
vector, and ``backward`` with the batch statistics against the
reference's and against plain autograd of the same forward. Eval mode,
``predict``, ``evaluate`` and ResNet-18 are in
``test_torch_module_surface_resnet_eval.py``. The models, tolerances and
helpers are ``test_torch_module_surface_models.py``'s (see its docstring
for the ResNet's 1e-4).
"""

import pytest
import torch

from test_torch_module_surface_models import (  # noqa: F401 (fixture)
    MODELS, RESNET_RTOL, _carry, _pair, _x, check_backward, check_summary,
    one_thread)


def test_summary_count_and_flat_vector_equal_the_reference():
    check_summary("resnet8_cifar")


def test_backward_matches_the_reference():
    check_backward("resnet8_cifar", True, RESNET_RTOL)


def test_training_backward_is_autograd_of_the_forward():
    _, tm = _pair("resnet8_cifar")
    tm.training_mode()
    x = torch.from_numpy(MODELS["resnet8_cifar"][2]())
    g = torch.from_numpy(_x((4, 10), seed=8))
    bufs = {k: v.clone() for k, v in tm.named_buffers()}
    got = tm.backward(x, g)
    for k, v in tm.named_buffers():
        assert torch.equal(v, bufs[k]), k
    leaf = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(tm(leaf), leaf, g)
    assert torch.equal(got, want)
    _carry(*_pair("resnet8_cifar"))   # the plain forward moved the stats
    tm.evaluate_mode()
