"""The module surface on ``build_lm`` at 2 layers and 64 wide, tied and
untied, the port against the JAX package on the CPU: summary, count and
flat vector, ``predict`` / ``predict_class``, a tied table counted once,
and ``backward`` refusing token ids. The models, tolerances and helpers
are ``test_torch_module_surface_models.py``'s.
"""

import pytest
import torch

from test_torch_module_surface_models import (  # noqa: F401 (fixture)
    MODELS, VOCAB, _pair, check_predict, check_summary, one_thread)

LMS = ["lm_tied", "lm_untied"]


@pytest.mark.parametrize("name", LMS)
def test_summary_count_and_flat_vector_equal_the_reference(name):
    check_summary(name)


@pytest.mark.parametrize("name", LMS)
def test_predict_and_predict_class_match_the_reference(name):
    check_predict(name)


def test_a_tied_head_counts_the_table_once():
    jm, tm = _pair("lm_tied")
    _, tu = _pair("lm_untied")
    assert tm.n_parameters() == jm.n_parameters() \
        == tu.n_parameters() - VOCAB * 64 - VOCAB


def test_backward_refuses_token_ids():
    _, tm = _pair("lm_untied")
    ids = torch.from_numpy(MODELS["lm_untied"][2]())
    with pytest.raises(TypeError, match="Sequential.backward"):
        tm.backward(ids, torch.ones(2, 12, VOCAB))
