"""Beam search of the port against the reference's with the GNMT length
penalty at 0.0 / 0.6 / 1.0 / 2.0 on the unfused tail, and on a tied head
and the Llama recipe: batches of two random prompts, f32, tokens identical.
The helpers and the other beam cases are in ``tests/test_torch_beam.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_beam import VOCAB, _both

torch.set_num_threads(1)


@pytest.mark.parametrize("kind, lp", [
    ("unfused", 0.0), ("unfused", 0.6), ("unfused", 1.0), ("unfused", 2.0),
    ("tied", 0.6), ("llama", 2.0)])
def test_beams_match_reference(kind, lp):
    prompt = np.random.default_rng(7).integers(1, VOCAB + 1, (2, 5))
    _both(kind, prompt, 7, num_beams=4, length_penalty=lp)
