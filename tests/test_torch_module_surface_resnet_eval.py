"""The module surface on the ResNets in eval mode, the port against the
JAX package on the CPU: ResNet-18's summary, count and flat vector, and
the CIFAR ResNet-8 at 32x32 through ``predict``, ``predict_class``,
``evaluate`` and an eval-mode ``backward``. Training mode is in
``test_torch_module_surface_resnet.py``; the models, tolerances and
helpers are ``test_torch_module_surface_models.py``'s.
"""

from test_torch_module_surface_models import (  # noqa: F401 (fixture)
    RESNET_RTOL, check_backward, check_evaluate, check_predict,
    check_summary, one_thread)


def test_summary_count_and_flat_vector_equal_the_reference():
    check_summary("resnet18")


def test_predict_and_predict_class_match_the_reference():
    check_predict("resnet8_cifar")


def test_evaluate_matches_the_reference():
    check_evaluate("resnet8_cifar")


def test_backward_matches_the_reference():
    check_backward("resnet8_cifar", False, RESNET_RTOL)
