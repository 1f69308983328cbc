"""Causal-LM train, generate and serve mains (counterpart of
``bigdl_tpu/apps/transformer.py``)::

    python -m bigdl_tpu_torch.apps.transformer train -b 8 --seqLen 256 -e 2
    python -m bigdl_tpu_torch.apps.transformer generate --prompt 3,5,7 \\
        --maxNewTokens 32 --numBeams 4 --bf16
    python -m bigdl_tpu_torch.apps.transformer serve --continuous \\
        --replicas 2 --int8 --port 8000

Every subcommand takes ``--device`` (default ``cuda``; ``cpu`` on request).
``train --checkpoint DIR`` writes a snapshot pair every epoch and the
trained module as ``DIR/model_final``; ``train --model M --state S``
resumes from a pair (``--autoResume``: the newest complete one under
``--checkpoint``). ``generate --model`` and ``serve --model`` load a saved
module onto ``--device``, ``serve --continuous --draft`` a saved draft.
Without ``--model``, ``generate`` and ``serve`` first train a tiny LM on the
synthetic grammar, as the reference does. ``train --textFile F
--bpeVocab N`` trains on real text instead: a byte-level BPE of N symbols
learned from F (``dataset/bpe.py``), saved beside the checkpoint as
``tokenizer.bigdl``, with the LM's vocabulary the tokenizer's (its
``eos_id``); ``generate --tokenizer`` and ``serve --tokenizer`` then take
text (a served POST may carry ``{"text": ...}``). The continuous engine
serves rope models only, so ``serve --continuous`` trains that default
model with the ``--llamaBlock`` recipe (RoPE, RMSNorm, SwiGLU and the
unfused ``TimeDistributed(Linear) + LogSoftMax`` tail); the reference's
non-rope default would be refused by its own engine.

``generate --fromHF DIR`` and ``serve --fromHF DIR`` load an HF checkpoint
directory (``interop/hf.py``) and its byte-level BPE tokenizer
(``interop/hf_tokenizer.py``): ``--prompt`` is then text, and a served
POST may carry ``{"text": ...}``. Without a tokenizer in DIR the prompt is
raw HF ids (0-based), and ``generate``'s ``--eosId`` is an HF id in both
cases, as in the reference.

An HF directory with a SentencePiece ``tokenizer.model`` (the Llama
family) speaks text through ``interop/sentencepiece.py``.

``train --tensorParallel N`` trains over a data x tensor mesh of the
group's processes (``MeshTopology(data=world // N, tensor=N)``) through
``Optimizer``, with sequence-parallel regions when ``--seqLen`` divides by
N; ``-b`` is the global batch. ``train --contextParallel ring|ulysses``
(``--ringLayout contiguous|zigzag``) shards the sequence over every
process (``_train_context_parallel``). Both start the process group from
the ``BIGDL_*`` environment (``--backend``: ``gloo`` for ranks that share
a card). ``--moeExperts N`` replaces every block's FFN with a top-2 routed
mixture of N experts (``parallel.expert.MoE``; not with ``--llamaBlock``,
as the reference; not with ``--contextParallel``; under
``--tensorParallel`` without sequence-parallel regions, whose sequence
blocks the router would see).
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from bigdl_tpu_torch.dataset.base import DataSet, Sample, SampleToBatch


def synthetic_corpus(n: int, seq_len: int, vocab: int,
                     seed: int = 17) -> List[Sample]:
    """Next-token samples over a learnable synthetic grammar: token t+1 is a
    fixed affine map of token t, replaced by a uniform draw one time in ten
    (the reference's ``_synthetic_corpus``, the same numbers from the same
    seed). Features and labels are 1-based ids as float32."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(n):
        toks = np.empty(seq_len + 1, np.int64)
        toks[0] = rng.randint(1, vocab + 1)
        for t in range(seq_len):
            nxt = (toks[t] * 31 + 7) % vocab + 1
            toks[t + 1] = nxt if rng.rand() < 0.9 \
                else rng.randint(1, vocab + 1)
        samples.append(Sample(toks[:-1].astype(np.float32),
                              toks[1:].astype(np.float32)))
    return samples


def text_corpus(args):
    """``(samples, vocab)`` of ``--textFile``: a BPE of ``--bpeVocab``
    symbols learned from its non-blank lines, each line encoded and ended
    by the tokenizer's eos, the stream cut into next-token samples of
    ``--seqLen`` (the reference's ``_text_corpus``, the same samples). The
    LM's vocabulary is the tokenizer's ``eos_id``; the tokenizer is saved
    as ``tokenizer.bigdl`` under ``--checkpoint``."""
    from bigdl_tpu_torch.dataset.bpe import BPETokenizer
    if args.bpeVocab < 256:
        raise SystemExit("--bpeVocab must be >= 256 (the byte alphabet)")
    with open(args.textFile, encoding="utf-8") as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    tok = BPETokenizer.train(lines, vocab_size=args.bpeVocab)
    stream = []
    for ln in lines:
        stream.extend(tok.encode(ln) + [tok.eos_id])
    s = args.seqLen
    samples = [Sample(np.asarray(stream[i:i + s], np.float32),
                      np.asarray(stream[i + 1:i + 1 + s], np.float32))
               for i in range(0, len(stream) - s, s)]
    if not samples:
        raise SystemExit(f"--textFile too small for --seqLen {s} "
                         f"({len(stream)} tokens)")
    if args.checkpoint:
        from bigdl_tpu_torch.utils import file_io
        tok.save(file_io.join(args.checkpoint, "tokenizer.bigdl"))
    print(f"text corpus: {len(stream)} tokens, BPE vocab {tok.vocab_size} "
          f"(+eos {tok.eos_id}), {len(samples)} samples", file=sys.stderr)
    return samples, tok.eos_id


def optimizer(argv):
    """The training run of ``argv`` (a causal LM on the synthetic grammar,
    or on ``--textFile``) as an ``Optimizer``, not yet started, and the
    parsed arguments."""
    from bigdl_tpu_torch.apps.common import build_optimizer, train_parser
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                              FusedLMHeadCriterion,
                                              TimeDistributedCriterion)

    parser = train_parser("bigdl_tpu_torch.apps.transformer train",
                          default_batch=8, default_epochs=2, default_lr=3e-3)
    parser.add_argument("--seqLen", type=int, default=128)
    parser.add_argument("--vocab", type=int, default=64)
    parser.add_argument("--embedDim", type=int, default=64)
    parser.add_argument("--numHeads", type=int, default=4)
    parser.add_argument("--numLayers", type=int, default=2)
    parser.add_argument("--contextParallel", default=None,
                        choices=[None, "ring", "ulysses"],
                        help="shard the sequence axis over the mesh")
    parser.add_argument("--moeExperts", type=int, default=0,
                        help="replace the FFN with a top-2 routed MoE")
    parser.add_argument("--tensorParallel", type=int, default=1,
                        help="Megatron TP degree")
    parser.add_argument("--ringLayout", default="contiguous",
                        choices=["contiguous", "zigzag"])
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="the process group's backend with "
                        "--tensorParallel/--contextParallel (default: nccl "
                        "on cards, gloo on the CPU)")
    parser.add_argument("--fusedHead", action="store_true",
                        help="LMHead + FusedLMHeadCriterion tail: the "
                        "(B,S,V) logits never materialise")
    parser.add_argument("--llamaBlock", action="store_true",
                        help="Llama-family block recipe: RoPE + RMSNorm + "
                        "SwiGLU, no biases (untied log-prob tail)")
    parser.add_argument("--textFile", default=None,
                        help="train on real text: a BPE of --bpeVocab "
                        "symbols learned from this file, saved beside "
                        "--checkpoint; --vocab is then the tokenizer's")
    parser.add_argument("--bpeVocab", type=int, default=512,
                        help="BPE vocabulary size (>= 256: the bytes and "
                        "the merges)")
    args = parser.parse_args(argv)
    if args.llamaBlock and args.moeExperts:
        raise SystemExit("--llamaBlock (swiglu FFN) does not compose with "
                         "--moeExperts yet")
    if args.moeExperts and args.contextParallel:
        raise SystemExit("--moeExperts does not compose with "
                         "--contextParallel: the router would see this "
                         "rank's sequence shard, not the batch")
    if args.contextParallel and args.tensorParallel > 1:
        raise SystemExit("--contextParallel and --tensorParallel do not "
                         "compose yet: pick one")
    if args.textFile:
        samples, args.vocab = text_corpus(args)
    else:
        samples = synthetic_corpus(max(args.synthetic_size, args.batchSize),
                                   args.seqLen, args.vocab)
    parallel = bool(args.contextParallel) or args.tensorParallel > 1
    world = _start_group(args) if parallel else 1
    data = world // args.tensorParallel if args.tensorParallel > 1 else 1
    if args.tensorParallel > 1 and world % args.tensorParallel:
        raise SystemExit(f"--tensorParallel {args.tensorParallel} must "
                         f"divide the process count {world}")
    if args.batchSize % data:
        raise SystemExit(f"-b {args.batchSize} must divide by the "
                         f"{data} data ranks")
    ds = DataSet.array(samples, distributed=parallel, seed=0).transform(
        SampleToBatch(batch_size=args.batchSize // data))
    llama = (dict(rope=True, norm="rms", activation="swiglu", bias=False)
             if args.llamaBlock else {})
    model = build_lm(args.vocab, args.embedDim, args.numHeads,
                     ffn_dim=4 * args.embedDim, num_layers=args.numLayers,
                     max_len=max(1024, args.seqLen),
                     fused_head=args.fusedHead, device=args.device, seed=0,
                     seq_axis="seq" if args.contextParallel else None,
                     seq_mode=args.contextParallel or "ring",
                     seq_layout=(args.ringLayout
                                 if args.contextParallel == "ring"
                                 else "contiguous"),
                     moe_experts=args.moeExperts, **llama)
    criterion = (FusedLMHeadCriterion() if args.fusedHead
                 else TimeDistributedCriterion(ClassNLLCriterion()))
    if args.contextParallel:
        return _ContextParallelRun(model, ds, criterion, args), args
    if args.tensorParallel > 1:
        from bigdl_tpu_torch.parallel.mesh import MeshTopology
        from bigdl_tpu_torch.parallel.tensor_parallel import \
            enable_sequence_parallel
        topo = MeshTopology(data=data, tensor=args.tensorParallel)
        opt = build_optimizer(model, ds, criterion, args, topology=topo)
        if args.seqLen % args.tensorParallel == 0 and not args.moeExperts:
            enable_sequence_parallel(model, opt.mesh)
        return opt, args
    return build_optimizer(model, ds, criterion, args), args


def _start_group(args) -> int:
    """The process group of the ``BIGDL_*`` environment (started here
    unless it is up); its process count."""
    import os

    from bigdl_tpu_torch.utils.engine import Engine
    if not Engine.process_group_up() and os.environ.get(
            "BIGDL_COORDINATOR_ADDRESS"):
        Engine.init_distributed(
            device="cpu" if args.device == "cpu" else None,
            backend=args.backend)
    return Engine.process_count()


class _ContextParallelRun:
    """``train --contextParallel``'s loop (reference
    ``_train_context_parallel``): the sequence sharded over every process
    (``MeshTopology(sequence=world)``); the embedding (and the positional
    encoding) run on the whole batch, the stack, head and criterion on
    this rank's shard (``parallel.context.ContextParallelLM``), each rank
    differentiates its shard's loss over the rank count and the gradients
    are summed over the ranks (the logged loss is their mean). SGD from the
    parsed rates; ``--checkpoint`` writes a snapshot pair every epoch from
    process 0 (the full model's leaves, as the standard loop's), and
    ``--model/--state`` or ``--autoResume`` resume from one."""

    def __init__(self, model, ds, criterion, args):
        from bigdl_tpu_torch.apps.common import redirect_logs
        from bigdl_tpu_torch.optim import SGD
        from bigdl_tpu_torch.parallel.context import ContextParallelLM
        from bigdl_tpu_torch.parallel.mesh import MeshTopology
        from bigdl_tpu_torch.utils.engine import Engine
        if bool(args.model) != bool(args.state):
            raise SystemExit("--model and --state must be passed together")
        redirect_logs()
        n = Engine.process_count()
        if args.seqLen % n:
            raise SystemExit(
                f"--seqLen {args.seqLen} is not divisible by the process "
                f"count {n}: sequence parallelism shards the sequence axis "
                "evenly; pick a multiple")
        zigzag = (args.contextParallel == "ring"
                  and args.ringLayout == "zigzag")
        if zigzag and args.seqLen % (2 * n):
            raise SystemExit(f"--ringLayout zigzag needs --seqLen divisible "
                             f"by 2x the process count ({2 * n})")
        self.mesh = MeshTopology(sequence=n).build(args.device)
        # every rank trains the whole batch: the records are not dealt
        from bigdl_tpu_torch.dataset.base import DistributedDataSet
        root = ds
        while not isinstance(root, DistributedDataSet) and hasattr(
                root, "base"):
            root = root.base
        if isinstance(root, DistributedDataSet):
            root.shard_by_data_rank(0, 1)
        self.lm = ContextParallelLM(model, self.mesh,
                                    layout=args.ringLayout if zigzag
                                    else "contiguous")
        self.model, self.ds, self.criterion, self.args = (model, ds,
                                                          criterion, args)
        self.method = SGD(learningrate=args.learningRate,
                          learningrate_decay=args.learningRateDecay,
                          momentum=args.momentum,
                          weightdecay=args.weightDecay)
        self.history = []

    def optimize(self):
        import logging

        import torch

        from bigdl_tpu_torch.resilience import coordinator
        from bigdl_tpu_torch.utils import file_io
        log = logging.getLogger("bigdl_tpu_torch.optim")
        args, model = self.args, self.model
        params = {n: p for n, p in model.named_parameters()}
        state = self.method.init_state(params)
        epoch, neval = 1, 1
        resume = (args.model, args.state) if args.model else None
        if resume is None and args.autoResume and args.checkpoint:
            point = coordinator.latest_resume_point(args.checkpoint)
            if point is not None:
                resume = (point.model_path, point.state_path)
        if resume is not None:
            from bigdl_tpu_torch.interop.state_dict import import_tree_state
            from bigdl_tpu_torch.optim.optimizer import _load_into
            snap = file_io.load(resume[0], device="cpu")
            st = file_io.load(resume[1], device="cpu")
            import_tree_state(model, snap["params"], snap.get("buffers", {}))
            with torch.no_grad():
                _load_into(state, st["optim"])
            epoch = int(st["driver"].get("epoch", 1))
            neval = int(st["driver"].get("neval", 1))
            log.info("[Resume] context-parallel from %s at epoch %d neval "
                     "%d", resume[0], epoch, neval)
        dev = torch.device(args.device)
        model.train()
        for epoch in range(epoch, args.maxEpoch + 1):
            self.ds.shuffle()
            for batch in self.ds.data(train=True):
                tokens = torch.as_tensor(batch.data).to(dev)
                targets = torch.as_tensor(batch.labels).to(dev)
                loss = self.lm.train_step(tokens, targets, self.criterion,
                                          self.method, state, params)
                log.info("[Epoch %d][Iteration %d] loss %.5f (seq-parallel "
                         "x%d, %s)", epoch, neval, loss, self.mesh.world,
                         args.contextParallel)
                self.history.append({"neval": neval, "epoch": epoch,
                                     "loss": loss})
                neval += 1
            if args.checkpoint:
                self._save(params, state, epoch, neval)
        return model

    def _save(self, params, state, epoch_done: int, neval: int) -> None:
        from bigdl_tpu_torch.resilience import coordinator
        from bigdl_tpu_torch.utils import file_io
        if self.mesh.process_rank == 0:
            model_path = file_io.join(self.args.checkpoint, f"model.{neval}")
            state_path = file_io.join(self.args.checkpoint, f"state.{neval}")
            host = file_io.to_host({
                "model": {"params": dict(params), "buffers": {}},
                "state": {"optim": state, "driver": {
                    "epoch": epoch_done + 1, "neval": neval}}})
            files = {"model": file_io.save(host["model"], model_path),
                     "state": file_io.save(host["state"], state_path)}
            coordinator.write_marker(
                state_path, step=neval, epoch=epoch_done + 1, rng=None,
                epoch_batches=0, epoch_records=0,
                mesh={"process_count": self.mesh.world,
                      "device_count": self.mesh.world,
                      "mesh_shape": dict(self.mesh.shape),
                      "sync_mode": "context-parallel"},
                cursor_epoch=epoch_done, files=files)
        self.mesh.barrier()


def train(argv):
    """Trains and returns the model; with ``--checkpoint`` saves
    ``model_final``."""
    opt, args = optimizer(argv)
    trained = opt.optimize()
    if args.checkpoint:
        from bigdl_tpu_torch.utils import file_io
        file_io.save(trained, file_io.join(args.checkpoint, "model_final"))
    return trained


def _default_model(device: str, rope: bool):
    print("no --model given: training a tiny LM on the synthetic grammar "
          "first", file=sys.stderr)
    argv = ["-b", "8", "--seqLen", "32", "--maxEpoch", "1",
            "--device", device]
    return train(argv + (["--llamaBlock"] if rope else []))


def _twin(model, args):
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    if args.int8:
        return quantize_model(model, device=args.device)
    if args.bf16:
        return cast_model(model, device=args.device)
    return model.evaluate_mode()


def _refuse_sources(args) -> None:
    if args.fromHF and args.model:
        raise SystemExit("pass --model or --fromHF, not both")
    if args.fromHF and args.tokenizer:
        raise SystemExit("--fromHF does not compose with --tokenizer (a "
                         "framework BPE vocab against an HF checkpoint's "
                         "vocab would decode garbage); the checkpoint "
                         "dir's own tokenizer loads automatically")


def _load_saved(path: str, device: str):
    """A module saved with ``file_io.save`` (``train --checkpoint``'s
    ``model_final``), on ``device``."""
    import torch

    from bigdl_tpu_torch.utils import file_io
    model = file_io.load(path, device=device)
    if not isinstance(model, torch.nn.Module):
        raise SystemExit(f"{path} holds no saved module (a training "
                         "snapshot resumes through train --model/--state)")
    return model


def _load_tokenizer(path: str):
    """A ``BPETokenizer`` saved by ``train --textFile``."""
    from bigdl_tpu_torch.dataset.bpe import BPETokenizer
    return BPETokenizer.load(path)


def _from_hf(path: str, device: str):
    """``(model, tokenizer or None)`` of an HF checkpoint directory: its
    byte-level BPE or SentencePiece tokenizer; an unreadable one leaves
    raw ids, as in the reference."""
    from bigdl_tpu_torch.interop.hf import load_hf_checkpoint
    from bigdl_tpu_torch.interop.hf_tokenizer import load_checkpoint_tokenizer
    tok = None
    try:
        tok = load_checkpoint_tokenizer(path)
        print(f"loaded {tok!r} from the checkpoint dir", file=sys.stderr)
    except FileNotFoundError:
        pass
    except ValueError as e:  # present but unreadable
        print(f"checkpoint tokenizer not readable ({e}); falling back to "
              "raw HF ids", file=sys.stderr)
    return load_hf_checkpoint(path, device=device), tok


def generate_cmd(argv) -> None:
    """Sample from an HF checkpoint (``--fromHF``) or from a fresh
    synthetic-grammar LM."""
    import argparse

    import torch

    from bigdl_tpu_torch.models.generation import generate

    ap = argparse.ArgumentParser(
        prog="bigdl_tpu_torch.apps.transformer generate")
    ap.add_argument("--model", default=None, help="saved model path")
    ap.add_argument("--fromHF", default=None, metavar="DIR",
                    help="a HuggingFace checkpoint directory (config.json + "
                    "safetensors); with its tokenizer --prompt is text, "
                    "else raw HF ids")
    ap.add_argument("--prompt", default="1,2,3",
                    help="comma-separated 1-based token ids")
    ap.add_argument("--maxNewTokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--topK", type=int, default=0)
    ap.add_argument("--topP", type=float, default=0.0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--numBeams", type=int, default=0)
    ap.add_argument("--lengthPenalty", type=float, default=1.0)
    ap.add_argument("--eosId", type=int, default=None,
                    help="end-of-sequence id (an HF id under --fromHF)")
    ap.add_argument("--repetitionPenalty", type=float, default=1.0)
    ap.add_argument("--minNewTokens", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="decode with the int8 weight-only quantized twin")
    ap.add_argument("--bf16", action="store_true",
                    help="decode with the bf16 cast twin")
    ap.add_argument("--tokenizer", default=None,
                    help="BPE tokenizer path (from train --textFile): "
                    "--prompt is then text and the continuation prints as "
                    "text")
    ap.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.int8 and args.bf16:
        raise SystemExit("pick one of --int8 / --bf16")
    _refuse_sources(args)
    tok, hf_shift = None, 0
    if args.fromHF:
        model, tok = _from_hf(args.fromHF, args.device)
        if args.eosId is not None:
            args.eosId += 1  # the CLI's eos under --fromHF is an HF id
        if tok is None:
            hf_shift = 1  # HF ids are 0-based, the framework's 1-based
    if args.tokenizer:
        tok = _load_tokenizer(args.tokenizer)
    if tok is not None:
        ids = tok.encode(args.prompt)
        if args.eosId is None:
            args.eosId = tok.eos_id
    else:
        ids = [int(t) + hf_shift for t in args.prompt.split(",") if t.strip()]
    if not ids:
        raise SystemExit("empty prompt: pass at least one token (text with "
                         "a checkpoint tokenizer, else comma-separated ids)")
    if args.model:
        model = _load_saved(args.model, args.device)
    elif not args.fromHF:
        model = _default_model(args.device, rope=False)
    model = _twin(model, args)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    out = generate(model, [ids], args.maxNewTokens,
                   temperature=args.temperature, top_k=args.topK,
                   top_p=args.topP, greedy=args.greedy,
                   num_beams=args.numBeams,
                   length_penalty=args.lengthPenalty, eos_id=args.eosId,
                   repetition_penalty=args.repetitionPenalty,
                   min_new_tokens=args.minNewTokens, generator=gen,
                   device=args.device)
    row = [t - hf_shift for t in out[0].tolist()]  # one host transfer
    n0 = len(ids)
    if tok is not None:
        print("prompt:      ", repr(tok.decode(row[:n0])))
        print("continuation:", repr(tok.decode(row[n0:])))
    else:
        print("prompt:      ", row[:n0])
        print("continuation:", row[n0:])


def serve_cmd(argv) -> None:
    """HTTP serving: ``LMServer``, or with ``--continuous`` the continuous
    engine, alone or as a fleet behind ``LMRouter`` (``--replicas N``,
    ``--disaggregate P:D``), with the ``BIGDL_CHAOS`` injectors, the
    SIGTERM drain and ``GET /metrics``."""
    import argparse

    ap = argparse.ArgumentParser(prog="bigdl_tpu_torch.apps.transformer serve")
    ap.add_argument("--model", default=None, help="saved model path")
    ap.add_argument("--fromHF", default=None, metavar="DIR",
                    help="a HuggingFace checkpoint directory; with its "
                    "tokenizer a POST may carry {\"text\": ...}")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--maxBatch", type=int, default=8,
                    help="micro-batch cap (requests gathered per dispatch)")
    ap.add_argument("--batchTimeoutMs", type=float, default=20.0,
                    help="how long a dispatch waits for same-length company")
    ap.add_argument("--maxNewTokens", type=int, default=64,
                    help="decode budget per request")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--topK", type=int, default=0)
    ap.add_argument("--topP", type=float, default=0.0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--eosId", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="serve the int8 weight-only quantized twin")
    ap.add_argument("--bf16", action="store_true",
                    help="serve the bf16 cast twin")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-scheduled continuous batching (rope models)")
    ap.add_argument("--slots", type=int, default=8,
                    help="--continuous: concurrent generation slots")
    ap.add_argument("--maxLen", type=int, default=256,
                    help="--continuous: per-slot KV cache length")
    ap.add_argument("--decodeBlock", type=int, default=8,
                    help="--continuous: tokens decoded per round")
    ap.add_argument("--prefillMode", default=None,
                    choices=("chunked", "bucketed"),
                    help="--continuous: prefill strategy (default chunked, "
                    "or BIGDL_PREFILL_MODE)")
    ap.add_argument("--prefillChunk", type=int, default=None,
                    help="--continuous: chunked-prefill width (default 128, "
                    "or BIGDL_PREFILL_CHUNK)")
    ap.add_argument("--draft", default=None, metavar="PATH",
                    help="--continuous: saved draft model path")
    ap.add_argument("--specLen", type=int, default=None,
                    help="--continuous --draft: draft tokens per round")
    ap.add_argument("--prefixCache", default=None, choices=("on", "off"),
                    help="--continuous: cross-request KV prefix cache")
    ap.add_argument("--prefixCacheMB", type=float, default=None,
                    help="--continuous: prefix-cache budget in MiB")
    ap.add_argument("--replicas", type=int, default=1,
                    help="--continuous: in-process replicas behind the "
                    "fleet router")
    ap.add_argument("--disaggregate", default=None, metavar="P:D",
                    help="--continuous: prefill:decode replica split (e.g. "
                    "1:2); overrides --replicas")
    ap.add_argument("--tokenizer", default=None,
                    help="BPE tokenizer path: a POST may then carry "
                    "{\"text\": ...} and answers include the text")
    ap.add_argument("--device", default="cuda",
                    help="where to serve: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.int8 and args.bf16:
        raise SystemExit("pick one of --int8 / --bf16")
    _refuse_sources(args)
    if not args.continuous:
        if args.draft or args.specLen or args.prefixCache:
            raise SystemExit("--draft/--specLen/--prefixCache require "
                             "--continuous")
        if args.replicas != 1 or args.disaggregate:
            raise SystemExit("--replicas/--disaggregate require --continuous")

    from bigdl_tpu_torch.models.lm_server import LMServer, make_http_server
    from bigdl_tpu_torch.resilience.serving_drill import parse_split

    split = parse_split(args.disaggregate) if args.continuous else None
    if args.draft and (sum(split) if split else args.replicas) > 1:
        raise SystemExit("--draft does not compose with a multi-replica "
                         "fleet (state handoff is incompatible with "
                         "speculative serving)")
    tok = None
    if args.fromHF:
        model, tok = _from_hf(args.fromHF, args.device)
    elif args.model:
        model = _load_saved(args.model, args.device)
    else:
        model = _default_model(args.device, rope=args.continuous)
    model = _twin(model, args)
    if args.tokenizer:
        tok = _load_tokenizer(args.tokenizer)
    if tok is not None and args.eosId is None:
        args.eosId = tok.eos_id
    if args.continuous:
        server = _continuous_fleet(model, args, split)
    else:
        server = LMServer(model, max_batch=args.maxBatch,
                          batch_timeout_ms=args.batchTimeoutMs,
                          max_new_tokens=args.maxNewTokens,
                          temperature=args.temperature, top_k=args.topK,
                          top_p=args.topP, greedy=args.greedy,
                          eos_id=args.eosId, seed=args.seed,
                          device=args.device)
    httpd = make_http_server(server, args.host, args.port, tokenizer=tok)

    # graceful drain: SIGTERM flips the PreemptionHandler flag; the watcher
    # drains the server or fleet (in-flight requests leave as handoff
    # cursors, /health turns 503 draining) and stops the HTTP loop
    import threading
    import time

    from bigdl_tpu_torch.resilience.preemption import PreemptionHandler
    preempt = PreemptionHandler().install()

    def watch_preemption():
        while not preempt.should_snapshot():
            time.sleep(0.1)
        reason = preempt.reason or "preemption notice"
        print(f"draining: {reason}", file=sys.stderr, flush=True)
        drain = getattr(server, "drain", None)
        if drain is not None:
            drain(reason)
        httpd.shutdown()

    threading.Thread(target=watch_preemption, daemon=True,
                     name="bigdl-serve-preempt").start()
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(POST /generate, GET /health, GET /metrics)", file=sys.stderr,
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        preempt.uninstall()


def _continuous_fleet(model, args, split):
    """One ``ContinuousLMServer``, or N of them behind ``LMRouter``. Each
    replica holds its own decode state, so each gets its own deep copy of
    the model (bit-equal weights: the handoff contract)."""
    import copy

    from bigdl_tpu_torch.models.serving import ContinuousLMServer
    from bigdl_tpu_torch.resilience.chaos import from_env as chaos_from_env

    n_decode = split[1] if split else max(1, args.replicas)
    n_prefill = split[0] if split else 0
    chaos = chaos_from_env()
    draft = _load_saved(args.draft, args.device) if args.draft else None

    def mk_server(mdl, slots, chaos_inj):
        return ContinuousLMServer(
            mdl, slots=slots, max_len=args.maxLen,
            decode_block=args.decodeBlock, max_new_tokens=args.maxNewTokens,
            temperature=args.temperature, top_k=args.topK, top_p=args.topP,
            greedy=args.greedy, eos_id=args.eosId, seed=args.seed,
            prefill_mode=args.prefillMode, prefill_chunk=args.prefillChunk,
            draft=draft, spec_len=args.specLen,
            prefix_cache=(None if args.prefixCache is None
                          else args.prefixCache == "on"),
            prefix_cache_mb=args.prefixCacheMB, chaos=chaos_inj,
            device=args.device)

    if n_decode + n_prefill == 1:
        return mk_server(model, args.slots, chaos)
    from bigdl_tpu_torch.models.router import LMRouter
    models = [model] + [copy.deepcopy(model)
                        for _ in range(n_decode + n_prefill - 1)]
    decode = [mk_server(models[i], args.slots, chaos if i == 0 else None)
              for i in range(n_decode)]
    prefill = [mk_server(models[n_decode + i], 1, None)
               for i in range(n_prefill)]
    print(f"fleet: {n_decode} decode"
          + (f" + {n_prefill} prefill" if n_prefill else "")
          + " replicas behind the router", file=sys.stderr, flush=True)
    return LMRouter(decode, prefill_replicas=prefill, chaos=chaos)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("train", "generate", "serve"):
        raise SystemExit("usage: python -m bigdl_tpu_torch.apps.transformer "
                         "{train|generate|serve} ...")
    if argv[0] == "generate":
        generate_cmd(argv[1:])
    elif argv[0] == "serve":
        serve_cmd(argv[1:])
    else:
        train(argv[1:])


if __name__ == "__main__":
    main()
