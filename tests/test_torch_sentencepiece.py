"""``interop/sentencepiece.py`` in the port against the JAX package's, on
the CPU: models written by each package's ``write_model`` are bit-equal;
ids are equal for unigram and BPE models, with and without
``byte_fallback``, on strings made from a seed (characters no piece covers
among them); the round trip holds, and an HF directory with a
``tokenizer.model`` loads through ``load_checkpoint_tokenizer``."""

import warnings

import numpy as np
import pytest
import torch

from bigdl_tpu.interop import sentencepiece as jsp
from bigdl_tpu_torch.interop import sentencepiece as sp
from bigdl_tpu_torch.interop.hf_tokenizer import load_checkpoint_tokenizer
from bigdl_tpu_torch.utils import protowire

ALPHABET = list("abcdefghij ") + ["é", "ü", "中", "🙂", "  "]
SPECIALS = [("<unk>", 0.0, sp.UNKNOWN), ("<s>", 0.0, sp.CONTROL),
            ("</s>", 0.0, sp.CONTROL)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pieces(seed, byte_fallback, n=120):
    """Specials, optionally the 256 byte pieces, then seeded pieces over
    a part of the alphabet with seeded scores (ties among them)."""
    rng = np.random.default_rng(seed)
    pieces = list(SPECIALS)
    if byte_fallback:
        pieces += [(f"<0x{b:02X}>", 0.0, sp.BYTE) for b in range(256)]
    seen = set()
    letters = list("abcdefgh") + ["é", "▁"]
    for ch in letters:
        seen.add(ch)
        pieces.append((ch, -float(rng.integers(5, 9)), sp.NORMAL))
    while len(seen) < n:
        p = "".join(rng.choice(letters, size=rng.integers(2, 5)))
        if p not in seen:
            seen.add(p)
            pieces.append((p, -float(rng.integers(1, 12)) / 2, sp.NORMAL))
    return pieces


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(ALPHABET, size=rng.integers(0, 24)))
            for _ in range(n)] + ["", " ", "  lead and  tail  "]


@pytest.mark.parametrize("model_type", ["unigram", "bpe"])
@pytest.mark.parametrize("byte_fallback", [False, True])
def test_ids_match_reference(model_type, byte_fallback, tmp_path):
    pieces = _pieces(11, byte_fallback)
    kw = dict(model_type=model_type, byte_fallback=byte_fallback)
    got_path = sp.write_model(str(tmp_path / "port.model"), pieces, **kw)
    want_path = jsp.write_model(str(tmp_path / "ref.model"), pieces, **kw)
    with open(got_path, "rb") as f, open(want_path, "rb") as g:
        assert f.read() == g.read()
    got = sp.SentencePieceTokenizer.from_file(got_path)
    want = jsp.SentencePieceTokenizer.from_file(want_path)
    assert (got.vocab_size, got.eos_id, got.bos_id) == \
        (want.vocab_size, want.eos_id, want.bos_id)
    for s in _texts(100, 5):
        ids = got.encode(s)
        assert ids == want.encode(s), repr(s)
        assert got.decode(ids) == want.decode(ids)
        if byte_fallback:   # every character is covered: exact round trip
            assert got.decode(ids) == s


@pytest.mark.parametrize("flags", [dict(add_dummy_prefix=False),
                                   dict(unk_id=0, bos_id=1, eos_id=2)])
def test_written_flags_parse_alike(flags, tmp_path):
    pieces = _pieces(3, True, n=40)
    path = sp.write_model(str(tmp_path / "m.model"), pieces, **flags)
    got = sp.SentencePieceModel.from_file(path)
    want = jsp.SentencePieceModel.from_file(path)
    for k in ("pieces", "scores", "types", "model_type", "unk_id", "bos_id",
              "eos_id", "pad_id", "byte_fallback", "normalizer",
              "has_charsmap", "add_dummy_prefix", "remove_extra_whitespaces",
              "escape_whitespaces"):
        assert getattr(got, k) == getattr(want, k), k


def test_nfkc_charsmap_warns_and_matches_reference(tmp_path):
    """A model with a precompiled charsmap is read with NFKC, with a
    warning, as in the reference."""
    from bigdl_tpu_torch.visualization.proto import _len_field, _varint_field
    path = sp.write_model(str(tmp_path / "m.model"), _pieces(4, True, 40))
    blob = open(path, "rb").read()
    norm = (_len_field(1, b"nmt_nfkc") + _len_field(2, b"\x01\x02")
            + _varint_field(3, 1))
    with open(path, "wb") as f:
        f.write(blob + _len_field(3, norm))
    with pytest.warns(UserWarning, match="NFKC"):
        got = sp.SentencePieceTokenizer.from_file(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jsp.SentencePieceTokenizer.from_file(path)
    for s in ["ｆｕｌｌ ａｂｃ", "ﬁ abc", "①②", "é"]:
        assert got.encode(s) == want.encode(s)


def test_protowire_reads_like_reference(tmp_path):
    from bigdl_tpu.utils import protowire as jpw
    path = sp.write_model(str(tmp_path / "m.model"), _pieces(2, False, 20))
    blob = open(path, "rb").read()
    assert list(protowire.iter_fields(blob)) == list(jpw.iter_fields(blob))
    assert protowire.read_varint(b"\xac\x02", 0) == (300, 2)
    with pytest.raises(EOFError):
        protowire.read_varint(b"\x80", 0)


def test_checkpoint_dir_dispatches_to_sentencepiece(tmp_path):
    sp.write_model(str(tmp_path / "tokenizer.model"), _pieces(9, True))
    tok = load_checkpoint_tokenizer(str(tmp_path))
    assert isinstance(tok, sp.SentencePieceTokenizer)
    want = jsp.SentencePieceTokenizer.from_dir(str(tmp_path))
    assert tok.encode("abc déf 🙂") == want.encode("abc déf 🙂")
