"""Shard generator (counterpart of ``bigdl_tpu/apps/seqfilegen.py``;
BigDL's ``models/utils/ImageNetSeqFileGenerator.scala``): pack a labelled
image tree into CRC-framed record shards (``dataset/shards.py``) with
parallel writers, so training never opens millions of small files.

    python -m bigdl_tpu_torch.apps.seqfilegen -f imagenet/ -o shards/ \
        -p 4 -b 1024        # packs train/ and val/ when present

Each record is one file's encoded bytes with its 1-based class label
(classes by sorted directory name). Writer i of ``-p`` packs every
``-p``-th file into ``part-{i:03d}-{n:05d}.bigdl-shard``, ``-b`` records a
shard. No model and no card is involved.
"""

from __future__ import annotations

import argparse
import logging
import os
from concurrent.futures import ThreadPoolExecutor

from bigdl_tpu_torch.dataset.image import image_folder_paths
from bigdl_tpu_torch.dataset.shards import ShardWriter, list_shards
from bigdl_tpu_torch.utils.logger_filter import redirect_logs

log = logging.getLogger("bigdl_tpu_torch.optim")


def _pack_worker(pairs, prefix: str, block_size: int) -> int:
    """One writer: (path, label) pairs into shards under its own prefix."""
    n = 0
    with ShardWriter(prefix, records_per_shard=block_size) as w:
        for path, label in pairs:
            with open(path, "rb") as f:
                w.write(label, f.read())
            n += 1
    return n


def pack_folder(folder: str, output: str, parallel: int = 1,
                block_size: int = 1024) -> int:
    """Pack one labelled image tree into ``output``; returns the record
    count."""
    pairs = image_folder_paths(folder)
    os.makedirs(output, exist_ok=True)
    chunks = [pairs[i::parallel] for i in range(parallel)]
    with ThreadPoolExecutor(max_workers=parallel) as pool:
        counts = list(pool.map(
            lambda iw: _pack_worker(iw[1],
                                    os.path.join(output, f"part-{iw[0]:03d}"),
                                    block_size),
            enumerate(chunks)))
    total = sum(counts)
    log.info("packed %d records from %s into %d shards under %s",
             total, folder, len(list_shards(output)), output)
    return total


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bigdl_tpu_torch.apps.seqfilegen")
    p.add_argument("-f", "--folder", required=True,
                   help="image tree root; train/ and val/ subtrees are "
                        "packed when present, else the root itself")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-p", "--parallel", type=int, default=1)
    p.add_argument("-b", "--blockSize", type=int, default=1024,
                   help="records per shard")
    p.add_argument("--trainOnly", action="store_true")
    p.add_argument("--validationOnly", action="store_true")
    args = p.parse_args(argv)
    redirect_logs()

    subtrees = []
    if os.path.isdir(os.path.join(args.folder, "train")) \
            and not args.validationOnly:
        subtrees.append(("train", os.path.join(args.folder, "train")))
    if os.path.isdir(os.path.join(args.folder, "val")) \
            and not args.trainOnly:
        subtrees.append(("val", os.path.join(args.folder, "val")))
    if not subtrees:
        subtrees = [("", args.folder)]
    total = 0
    for name, tree in subtrees:
        out = os.path.join(args.output, name) if name else args.output
        total += pack_folder(tree, out, args.parallel, args.blockSize)
    print(f"packed {total} records")


if __name__ == "__main__":
    main()
