"""The SimpleRNN language model's train main (counterpart of
``bigdl_tpu/apps/rnn.py``):

    python -m bigdl_tpu_torch.apps.rnn train [-f TEXT_FILE] [-b 12]
        [--hiddenSize 40] [--sequenceLength 16] [--device cuda|cpu]

Sentences (the lines of ``-f``, else a synthetic corpus from the
reference's seed) go through ``SentenceTokenizer`` ->
``SentenceBiPadding`` -> ``Dictionary`` -> ``TextToLabeledSentence`` ->
``LabeledSentenceToSample(one_hot, fixed_length)`` -> ``SampleToBatch``;
``models/rnn.py``'s ``build`` trains under
``TimeDistributedCriterion(ClassNLLCriterion())``, validated by its loss
every epoch.
"""

from __future__ import annotations

import sys

import numpy as np

from bigdl_tpu_torch.apps.common import build_optimizer, train_parser
from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
from bigdl_tpu_torch.dataset.text import (Dictionary, LabeledSentenceToSample,
                                          SentenceBiPadding, SentenceTokenizer,
                                          TextToLabeledSentence)
from bigdl_tpu_torch.models import rnn
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.optim import Loss
from bigdl_tpu_torch.utils import file_io

_SYNTH_VOCAB = ["the", "quick", "brown", "fox", "jumps", "over", "lazy",
                "dog", "a", "cat", "sat", "on", "mat"]


def _synthetic_corpus(n: int, max_len: int = 12):
    rng = np.random.RandomState(3)
    return [" ".join(rng.choice(_SYNTH_VOCAB,
                                size=rng.randint(4, max_len)).tolist())
            for _ in range(n)]


def _pipeline(sentences, batch, fixed_len):
    """(batched dataset, vocabulary size + 1 for the unknown slot)."""
    tokens = list(SentenceTokenizer()(iter(sentences)))
    tokens = list(SentenceBiPadding()(iter(tokens)))
    dictionary = Dictionary(iter(tokens), vocab_size=4000)
    vocab = dictionary.vocab_size() + 1
    labeled = TextToLabeledSentence(dictionary)(iter(tokens))
    samples = LabeledSentenceToSample(
        vocab, fixed_length=fixed_len, one_hot=True)(labeled)
    ds = DataSet.array(list(samples)).transform(
        SampleToBatch(batch_size=batch))
    return ds, vocab


def optimizer(argv):
    """The training run of ``argv`` as an ``Optimizer``, not yet
    started."""
    parser = train_parser("bigdl_tpu_torch.apps.rnn train",
                          default_batch=12, default_epochs=2, default_lr=0.1)
    parser.add_argument("--hiddenSize", type=int, default=40)
    parser.add_argument("--sequenceLength", type=int, default=16)
    args = parser.parse_args(argv)
    if args.folder:
        with open(args.folder) as f:
            sentences = [line.strip() for line in f if line.strip()]
    else:
        sentences = _synthetic_corpus(args.synthetic_size // 8)
    ds, vocab = _pipeline(sentences, args.batchSize, args.sequenceLength)
    model = rnn.build(vocab, args.hiddenSize, vocab, device=args.device)
    criterion = TimeDistributedCriterion(ClassNLLCriterion(),
                                         size_average=True)
    return build_optimizer(model, ds, criterion, args, validation_set=ds,
                           methods=[Loss(criterion)])


def train(argv):
    """Trains and returns the model (saved as ``model_final`` under
    ``--checkpoint``)."""
    opt = optimizer(argv)
    trained = opt.optimize()
    if opt.checkpoint_path:
        file_io.save(trained, file_io.join(opt.checkpoint_path,
                                           "model_final"))
    return trained


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "train":
        raise SystemExit("usage: python -m bigdl_tpu_torch.apps.rnn train ...")
    train(argv[1:])


if __name__ == "__main__":
    main()
