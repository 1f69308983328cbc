"""The text apps and models in the port against the JAX package's, on the
CPU:

- ``models/textclassifier.build_cnn`` with the reference's weights carried
  across: log-probabilities and every gradient within 1e-5 (relative L2);
- ``transformer train --textFile``: the samples equal the reference's
  ``_text_corpus``'s; the app's training from shared initial weights
  (the first batch's loss within 1e-4, the weights after 3 SGD steps
  within ``test_torch_lm_train.py``'s 1e-4 absolute plus 1e-3 relative).

The app mains (textclassifier, rnn, ``generate|serve --tokenizer``,
``--summary``) are in ``test_torch_text_app_mains.py``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.models.transformer as jtransformer
import bigdl_tpu_torch.models.transformer as ttransformer
from bigdl_tpu import nn as jnn
from bigdl_tpu.apps import transformer as jtr_app
from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import textclassifier as jtc
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.apps import transformer as tr_app
from bigdl_tpu_torch.dataset.bpe import BPETokenizer
from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                flatten_tree,
                                                import_lm_state_dict,
                                                import_tree_state)
from bigdl_tpu_torch.models import textclassifier

WORDS = ["the", "cat", "sat", "on", "mat", "über", "naïve", "café", "日本",
         "a", "dog", "ran", "far"]
LOSS_TOL = 1e-4
WEIGHT_TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_RTOL = 1e-5
SEQ = 8
TINY = ["--embedDim", "16", "--numHeads", "2", "--numLayers", "1",
        "--seqLen", str(SEQ), "--llamaBlock", "--bpeVocab", "300"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ------------------------------------------------------------ build_cnn
def test_build_cnn_matches_reference():
    t, e, classes = 160, 8, 4
    jm = jtc.build_cnn(classes, t, e)
    tm = textclassifier.build_cnn(classes, t, e, device="cpu")
    import_tree_state(tm, flatten_tree(jm.parameter_tree()),
                      flatten_tree(jm.buffer_tree()))
    x = np.random.default_rng(0).normal(size=(3, t, e)).astype(np.float32)
    y = np.array([1, 4, 2], np.float32)
    assert textclassifier.conv_output_length(1000) == \
        jtc.conv_output_length(1000) == 35

    def loss_fn(params, xin):
        out, _ = functional_apply(jm, params, jm.buffer_tree(), xin,
                                  training=True)
        return jnn.ClassNLLCriterion().apply(out, jnp.asarray(y)), out

    (ref_loss, ref_out), (ref_g, ref_dx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(jm.parameter_tree(),
                                               jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    loss = nn.ClassNLLCriterion()(out, torch.from_numpy(y))
    loss.backward()
    assert _rel(out.detach().numpy(), ref_out) <= GRAD_RTOL
    assert abs(loss.item() - float(ref_loss)) <= GRAD_RTOL * float(ref_loss)
    ref_g = flatten_tree(ref_g)
    for name, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), ref_g[name]) <= GRAD_RTOL, name
    assert _rel(xt.grad.numpy(), ref_dx) <= GRAD_RTOL
    with pytest.raises(ValueError, match="149"):
        textclassifier.build_cnn(2, 148, 4, device="cpu")


# ------------------------------------------------- transformer --textFile
def _corpus_file(tmp_path, n_lines, seed=0):
    rng = np.random.default_rng(seed)
    path = tmp_path / "corpus.txt"
    lines = [" ".join(rng.choice(WORDS, size=rng.integers(2, 9)).tolist())
             for _ in range(n_lines)]
    path.write_text("\n".join(lines[:n_lines // 2]) + "\n\n"
                    + "\n".join(lines[n_lines // 2:]) + "\n", encoding="utf-8")
    return str(path)


def test_text_corpus_matches_reference(tmp_path):
    args = argparse.Namespace(textFile=_corpus_file(tmp_path, 60),
                              bpeVocab=320, seqLen=SEQ,
                              checkpoint=str(tmp_path / "ck"))
    got, vocab = tr_app.text_corpus(args)
    args.checkpoint = str(tmp_path / "ck_ref")
    want, jvocab = jtr_app._text_corpus(args)
    assert vocab == jvocab and len(got) == len(want) > 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.feature, w.feature)
        np.testing.assert_array_equal(g.label, w.label)
    port_tok = BPETokenizer.load(str(tmp_path / "ck" / "tokenizer.bigdl"))
    ref_tok = BPETokenizer.load(str(tmp_path / "ck_ref" / "tokenizer.bigdl"))
    assert port_tok.merges == ref_tok.merges and port_tok.eos_id == vocab
    args.bpeVocab = 255
    with pytest.raises(SystemExit, match=">= 256"):
        tr_app.text_corpus(args)


def test_text_training_matches_reference(tmp_path, monkeypatch):
    path = _corpus_file(tmp_path, 40, seed=1)
    args = argparse.Namespace(textFile=path, bpeVocab=300, seqLen=SEQ,
                              checkpoint=None)
    samples, vocab = tr_app.text_corpus(args)
    x = np.stack([s.feature for s in samples])
    y = np.stack([s.label for s in samples])
    # one batch an epoch: each package's shuffle only reorders its rows
    argv = ["--textFile", path, "-b", str(len(samples)), "-e", "3"] + TINY
    start = {}
    real_ref, real_port = jtransformer.build_lm, ttransformer.build_lm

    def ref_build(*a, **kw):
        m = real_ref(*a, **kw)
        start["state"] = {k: np.array(v) for k, v in jax_export(m).items()}
        out, _ = functional_apply(m, m.parameter_tree(), m.buffer_tree(),
                                  jnp.asarray(x), training=False)
        start["loss"] = float(jnn.TimeDistributedCriterion(
            jnn.ClassNLLCriterion()).apply(out, jnp.asarray(y)))
        return m

    def port_build(*a, **kw):
        m = real_port(*a, **kw)
        import_lm_state_dict(m, start["state"])
        with torch.no_grad():
            start["port_loss"] = nn.TimeDistributedCriterion(
                nn.ClassNLLCriterion())(m(torch.from_numpy(x)),
                                        torch.from_numpy(y)).item()
        return m

    monkeypatch.setattr(jtransformer, "build_lm", ref_build)
    monkeypatch.setattr(ttransformer, "build_lm", port_build)
    ref_trained = jtr_app.train(argv)
    port_trained = tr_app.train(argv + ["--device", "cpu"])
    assert abs(start["port_loss"] - start["loss"]) <= LOSS_TOL
    got, want = export_lm_state_dict(port_trained), jax_export(ref_trained)
    assert sorted(got) == sorted(want)
    moved = 0.0
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **WEIGHT_TOL,
                                   err_msg=k)
        moved = max(moved, float(np.abs(got[k] - start["state"][k]).max()))
    assert moved > 0.0


NEW_MODULES = ("utils/protowire.py", "visualization/proto.py",
               "visualization/tensorboard.py", "visualization/summary.py",
               "visualization/__init__.py", "dataset/text.py",
               "dataset/bpe.py", "interop/sentencepiece.py",
               "models/textclassifier.py", "apps/textclassifier.py",
               "apps/rnn.py", "tensor/tensor.py", "tensor/__init__.py",
               "ml/classifier.py", "ml/__init__.py")


@pytest.mark.parametrize("mod", NEW_MODULES)
def test_new_module_names_its_mirror(mod):
    from pathlib import Path
    pkg = Path(__file__).resolve().parent.parent / "bigdl_tpu_torch"
    doc = (pkg / mod).read_text().split('"""')[1]
    mirror = "bigdl_tpu/" + mod.rsplit("/", 1)[0]
    assert mirror in doc, mod


@pytest.mark.parametrize("entry", ["build_cnn", "textclassifier train",
                                   "rnn train"])
def test_text_entry_points_need_the_card_or_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bigdl_tpu_torch.apps import rnn as rnn_app
    from bigdl_tpu_torch.apps import textclassifier as tc_app
    calls = {"build_cnn": lambda: textclassifier.build_cnn(2, 160, 4),
             "textclassifier train": lambda: tc_app.main(
                 ["train", "--maxSequenceLength", "160", "--embeddingDim",
                  "4", "--synthetic-size", "16", "-b", "4"]),
             "rnn train": lambda: rnn_app.main(
                 ["train", "--synthetic-size", "64", "-b", "4"])}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
