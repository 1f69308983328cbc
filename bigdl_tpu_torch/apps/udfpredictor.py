"""Text prediction as a per-row function and over a watched folder
(counterpart of ``bigdl_tpu/apps/udfpredictor.py``; BigDL's
``example/udfpredictor/``, a Spark SQL UDF over a trained text classifier
applied to a DataFrame or a structured stream of text files).

``make_udf`` returns a plain callable ``text -> 1-based class``;
``predict_texts`` classifies a list in batches; ``run`` classifies a
folder's ``.txt`` files and, with ``--watch``, keeps polling for new ones,
classifying each file once. The model is the ``classifier_bundle`` that
``apps.textclassifier train --checkpoint DIR`` writes (the model, the
vocabulary, the embeddings and the sequence length), on ``--device`` (the
card by default).

    python -m bigdl_tpu_torch.apps.textclassifier train --checkpoint ck
    python -m bigdl_tpu_torch.apps.udfpredictor \
        --modelPath ck/classifier_bundle -f texts/ [--watch]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, List, Optional, Tuple

import torch

from bigdl_tpu_torch.apps.textclassifier import tokenize
from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
from bigdl_tpu_torch.dataset.text import (IndexedToEmbeddedSample,
                                          TokensToIndexedSample)
from bigdl_tpu_torch.optim import Predictor
from bigdl_tpu_torch.optim.evaluator import evaluating
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.device import DeviceLike, check_module_device
from bigdl_tpu_torch.utils.logger_filter import redirect_logs


def _bundle_pipeline(bundle):
    """tokens -> indices -> embedded samples, from a classifier bundle."""
    return (TokensToIndexedSample(bundle["word2index"], bundle["seq_len"]),
            IndexedToEmbeddedSample(bundle["embeddings"]))


def predict_texts(bundle, texts: List[str], batch_size: int = 32,
                  device: DeviceLike = "cuda") -> List[int]:
    """Classify raw texts with a bundle: tokenize, index, embed, batched
    forward on ``device``."""
    to_indexed, embed = _bundle_pipeline(bundle)
    samples = list(to_indexed((tokenize(t), 0.0) for t in texts))
    ds = (DataSet.array(samples) >> embed
          >> SampleToBatch(batch_size=batch_size, drop_remainder=False))
    preds = Predictor(bundle["model"], batch_size,
                      device=device).predict_class(ds)
    return torch.cat(preds).cpu()[:len(texts)].tolist()


def make_udf(bundle, device: DeviceLike = "cuda") -> Callable[[str], int]:
    """The reference's ``udf(predict _)``: ``text -> class`` through one
    eval-mode forward of the bundle's model on ``device``."""
    model = bundle["model"]
    dev = check_module_device(model, device)
    to_indexed, embed = _bundle_pipeline(bundle)

    def udf(text: str) -> int:
        sample = next(embed(to_indexed(iter([(tokenize(text), 0.0)]))))
        x = torch.as_tensor(sample.feature)[None].to(dev)
        with evaluating(model):
            out = model(x)
        return int(out.argmax(dim=-1)[0]) + 1

    return udf


def _classify_files(bundle, paths: List[str], batch_size: int,
                    device) -> List[Tuple[str, int]]:
    texts = []
    for p in paths:
        with open(p, encoding="latin-1") as f:
            texts.append(f.read())
    return list(zip(paths, predict_texts(bundle, texts, batch_size, device)))


def run(argv=None, max_polls: Optional[int] = None,
        on_poll: Optional[Callable[[List[Tuple[str, int]]], None]] = None
        ) -> List[Tuple[str, int]]:
    """Prints and returns the (path, class) rows; with ``--watch`` polls
    every ``--pollSeconds`` until ``max_polls`` polls (forever without).
    ``on_poll`` is called after each poll with the rows it classified."""
    p = argparse.ArgumentParser(prog="bigdl_tpu_torch.apps.udfpredictor")
    p.add_argument("--modelPath", required=True,
                   help="classifier bundle saved by textclassifier train")
    p.add_argument("-f", "--folder", required=True,
                   help="directory of .txt documents")
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("--watch", action="store_true",
                   help="keep polling for new files (structured-stream mode)")
    p.add_argument("--pollSeconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda",
                   help="where to run the model: cuda (default) or cpu")
    args = p.parse_args(argv)
    redirect_logs()

    bundle = file_io.load(args.modelPath, device=args.device)
    seen = set()
    rows: List[Tuple[str, int]] = []
    polls = 0
    while True:
        paths = sorted(
            os.path.join(args.folder, n) for n in os.listdir(args.folder)
            if n.endswith(".txt") and n not in seen)
        seen.update(os.path.basename(p) for p in paths)
        batch_rows = _classify_files(bundle, paths, args.batchSize,
                                     args.device) if paths else []
        for path, cls in batch_rows:
            print(f"{path}\t{cls}", flush=True)
        rows.extend(batch_rows)
        if on_poll is not None:
            on_poll(batch_rows)
        polls += 1
        if not args.watch or (max_polls is not None and polls >= max_polls):
            return rows
        time.sleep(args.pollSeconds)


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
