"""The module surface on Inception v1, the port against the JAX package on
the CPU: the whole tower's summary, count and flat vector, and two of its
blocks at a small width through ``predict``, ``predict_class`` and
``backward``. The models, tolerances and helpers are
``test_torch_module_surface_models.py``'s.
"""

import pytest

from test_torch_module_surface_models import (  # noqa: F401 (fixture)
    RTOL, check_backward, check_predict, check_summary, one_thread)


@pytest.mark.parametrize("name", ["inception_blocks", "inception_v1"])
def test_summary_count_and_flat_vector_equal_the_reference(name):
    check_summary(name)


def test_predict_and_predict_class_match_the_reference():
    check_predict("inception_blocks")


def test_backward_matches_the_reference():
    check_backward("inception_blocks", False, RTOL)
