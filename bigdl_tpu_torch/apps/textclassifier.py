"""The text classifier's train main (counterpart of
``bigdl_tpu/apps/textclassifier.py``): GloVe embeddings and a CNN over a
20-newsgroup-style category folder, trained with ``Adagrad`` and
validated by Top-1 every epoch.

    python -m bigdl_tpu_torch.apps.textclassifier train [-f BASE_DIR]
        [-b 128] [--maxSequenceLength 1000] [--embeddingDim 100]
        [--checkpoint DIR] [--device cuda|cpu]

``-f BASE_DIR`` reads ``BASE_DIR/20_newsgroup/<category>/<documents>`` and
``BASE_DIR/glove.6B/glove.6B.<embeddingDim>d.txt``, the reference's
layout. Without it a synthetic corpus with one marker vocabulary per class
and random embeddings, from the reference's seeds, stands in.
``--checkpoint DIR`` saves ``model_final`` and a ``classifier_bundle``
(the model, the vocabulary, the embeddings and the sequence length).
"""

from __future__ import annotations

import logging
import sys

import numpy as np

from bigdl_tpu_torch.apps.common import build_optimizer, train_parser
from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
from bigdl_tpu_torch.dataset.text import (Dictionary, IndexedToEmbeddedSample,
                                          TokensToIndexedSample,
                                          load_category_folder,
                                          load_glove_vectors)
from bigdl_tpu_torch.models import textclassifier
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
from bigdl_tpu_torch.optim import Adagrad, Top1Accuracy
from bigdl_tpu_torch.utils import file_io

log = logging.getLogger("bigdl_tpu_torch.optim")

_SYNTH_CLASSES = 4
_SYNTH_SHARED = ["the", "a", "of", "to", "and", "in", "is", "it"]


def tokenize(text: str):
    """Lower-case words of letters only (the reference's
    ``SimpleTokenizer.toTokens``)."""
    return [t for t in
            ("".join(c if c.isalpha() else " " for c in text.lower())).split()
            if t]


def _synthetic_corpus(n: int, rng: np.random.RandomState):
    """Class-separable texts: each class has its own marker words."""
    texts, labels = [], []
    for i in range(n):
        label = i % _SYNTH_CLASSES + 1
        markers = [f"klass{'abcd'[label - 1]}{'mnopqr'[j]}" for j in range(6)]
        words = rng.choice(markers + _SYNTH_SHARED,
                           size=rng.randint(30, 80)).tolist()
        texts.append(" ".join(words))
        labels.append(float(label))
    return texts, labels, _SYNTH_CLASSES


def prepare(args):
    """Corpus -> (train samples, validation samples, class count,
    embeddings, vocabulary): tokenize, keep the ``maxWordsNum`` most
    frequent words, store token indices (embedded per batch by
    ``IndexedToEmbeddedSample``), shuffle and split."""
    rng = np.random.RandomState(42)
    if args.folder:
        texts, labels, class_num = load_category_folder(
            f"{args.folder}/20_newsgroup")
    else:
        texts, labels, class_num = _synthetic_corpus(args.synthetic_size, rng)
    token_lists = [tokenize(t) for t in texts]
    word2index = Dictionary(iter(token_lists),
                            vocab_size=args.maxWordsNum).word2index()
    if args.folder:
        embeddings = load_glove_vectors(
            f"{args.folder}/glove.6B/glove.6B.{args.embeddingDim}d.txt",
            word2index, args.embeddingDim)
    else:
        embeddings = rng.randn(
            len(word2index) + 1, args.embeddingDim).astype(np.float32)
        embeddings[0] = 0.0
    pairs = list(zip(token_lists, labels))
    rng.shuffle(pairs)
    split = int(len(pairs) * args.trainingSplit)
    to_indexed = TokensToIndexedSample(word2index, args.maxSequenceLength)
    train_samples = list(to_indexed(iter(pairs[:split])))
    val_samples = list(to_indexed(iter(pairs[split:])))
    return train_samples, val_samples, class_num, embeddings, word2index


def parser():
    p = train_parser("bigdl_tpu_torch.apps.textclassifier train",
                     default_batch=128, default_epochs=20, default_lr=0.01)
    p.set_defaults(learningRateDecay=0.0002, synthetic_size=512)
    p.add_argument("--maxSequenceLength", type=int, default=1000)
    p.add_argument("--maxWordsNum", type=int, default=5000)
    p.add_argument("--embeddingDim", type=int, default=100)
    p.add_argument("--trainingSplit", type=float, default=0.8)
    return p


def optimizer(argv):
    """The training run of ``argv`` as an ``Optimizer``, not yet started,
    and the ``prepare`` outputs it trains on."""
    args = parser().parse_args(argv)
    prepared = prepare(args)
    train_samples, val_samples, class_num, embeddings, _ = prepared
    log.info("Found %d texts, %d classes.",
             len(train_samples) + len(val_samples), class_num)
    embed = IndexedToEmbeddedSample(embeddings)
    train_set = DataSet.array(train_samples).transform(embed).transform(
        SampleToBatch(batch_size=args.batchSize))
    val_set = DataSet.array(val_samples).transform(embed).transform(
        SampleToBatch(batch_size=args.batchSize, drop_remainder=False))
    model = textclassifier.build_cnn(class_num, args.maxSequenceLength,
                                     args.embeddingDim, device=args.device)
    opt = build_optimizer(
        model, train_set, ClassNLLCriterion(), args,
        validation_set=val_set, methods=[Top1Accuracy()],
        optim_method=Adagrad(learningrate=args.learningRate,
                             learningrate_decay=args.learningRateDecay,
                             weightdecay=args.weightDecay))
    return opt, args, prepared


def train(argv):
    """Trains and returns the model; with ``--checkpoint`` saves
    ``model_final`` and the ``classifier_bundle``."""
    opt, args, (_, _, _, embeddings, word2index) = optimizer(argv)
    trained = opt.optimize()
    if args.checkpoint:
        file_io.save(trained, file_io.join(args.checkpoint, "model_final"))
        file_io.save({"model": trained, "word2index": word2index,
                      "embeddings": embeddings,
                      "seq_len": args.maxSequenceLength},
                     file_io.join(args.checkpoint, "classifier_bundle"))
    return trained


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "train":
        raise SystemExit(
            "usage: python -m bigdl_tpu_torch.apps.textclassifier train ...")
    train(argv[1:])


if __name__ == "__main__":
    main()
