"""``dataset/bpe.py`` in the port against the JAX package's, on the CPU:
merges and ids exactly equal on corpora made from a seed (among them ones
built so that pairs tie on frequency, where the reference breaks ties on
the larger pair), the exact round trip, and save/load across the two
packages."""

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset.bpe import BPETokenizer as JaxBPE
from bigdl_tpu_torch.dataset.bpe import BPETokenizer, _to_words

WORDS = ["low", "lower", "newest", "widest", "the", "cat", "über", "naïve",
         "café", "日本", "🙂", "a\tb", "x\ny", "ab", "ba"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=rng.integers(1, 12)).tolist())
            for _ in range(n)]


@pytest.mark.parametrize("seed, vocab", [(0, 300), (1, 400), (2, 512)])
def test_merges_and_ids_match_reference(seed, vocab):
    lines = _corpus(300, seed)
    got, want = BPETokenizer.train(lines, vocab), JaxBPE.train(lines, vocab)
    assert got.merges == want.merges
    assert got.vocab_size == want.vocab_size and got.eos_id == want.eos_id
    for line in _corpus(50, seed + 100) + ["", " ", "  lead", "tail  "]:
        ids = got.encode(line)
        assert ids == want.encode(line)
        assert got.decode(ids) == line
    assert got.decode([got.eos_id, 1]) == want.decode([want.eos_id, 1])


def test_ties_break_on_the_larger_pair():
    # every adjacent pair occurs exactly twice: the reference's max over
    # (freq, pair) takes the largest pair first
    lines = ["ab cd", "ab cd", "ef gh", "ef gh"]
    got, want = BPETokenizer.train(lines, 262), JaxBPE.train(lines, 262)
    assert got.merges == want.merges
    assert got.merges[0] == max(got.merges[:1] + [(ord("g"), ord("h"))])
    assert _to_words("a b  c") == [b"a", b" b", b" ", b" c"]


def test_min_freq_and_vocab_bound_match_reference():
    lines = _corpus(40, 7)
    for vocab, min_freq in ((256, 2), (1000, 5), (1000, 1000)):
        got = BPETokenizer.train(lines, vocab, min_freq)
        want = JaxBPE.train(lines, vocab, min_freq)
        assert got.merges == want.merges and got.vocab_size <= vocab
    with pytest.raises(ValueError):
        BPETokenizer.train(lines, 255)


def test_save_load_across_packages(tmp_path):
    lines = _corpus(200, 3)
    got, want = BPETokenizer.train(lines, 350), JaxBPE.train(lines, 350)
    got.save(str(tmp_path / "port.bigdl"))
    want.save(str(tmp_path / "ref.bigdl"))
    assert JaxBPE.load(str(tmp_path / "port.bigdl")).merges == want.merges
    back = BPETokenizer.load(str(tmp_path / "ref.bigdl"))
    assert back.merges == got.merges
    line = "the naïve café 🙂"
    assert back.encode(line) == want.encode(line)
