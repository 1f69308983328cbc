"""Continuous-batching LM serving engine (counterpart of
``bigdl_tpu/models/serving.py``).

The bucketed ``LMServer`` groups requests by exact prompt length and
decodes whole batches in lockstep: one long generation blocks its bucket,
and mixed lengths fragment into tiny batches. This engine schedules SLOTS
instead:

- the model stays in continuous decode mode: (slots, L) KV caches with a
  per-row ``decode_pos`` (``MultiHeadAttention._attend_decode_continuous``),
  so every slot decodes at its own position and one forward advances all;
- a new request prefills out of band as a b=1 forward. ``"chunked"`` mode
  (the default) runs ceil((P-1)/C) fixed-width chunks through the warm-cache
  masked attention and one single-token step for the last prompt token;
  ``"bucketed"`` mode right-pads the prompt to its power-of-two bucket and
  runs the cold causal prefill (kernel K1 on the card). The b=1 cache is
  then copied into a free slot row and that row's ``decode_pos`` set;
- steps run in blocks of ``decode_block`` tokens, whose tokens are copied
  to the host once; finished rows free their slot at the next block
  boundary and the queue admits strictly FIFO.

Free slots keep decoding garbage, as in the reference; the attention
clamps the cache writes of rows past the cache end, and their outputs are
never read. On top of the engine:

- the cross-request prefix cache (``models/prefix_cache.py``, chunked mode,
  on by default; ``BIGDL_PREFIX_CACHE=0`` turns it off);
- speculative decode (``draft=...``, ``BIGDL_SPEC_LEN``, greedy only): the
  draft keeps its own (slots, L) continuous state, prefilled on every
  admission; each round it proposes ``spec_len`` tokens per row and the
  target verifies the carried token and the proposals in one multi-token
  forward. Per-row first-mismatch acceptance emits 1..spec_len+1 tokens,
  and both caches roll back per row (``_shift_decode_pos``);
- ``drain()`` with ``HandoffCursor``s, and prefill/decode handoff
  (``prefill_handoff`` into ``submit(state=...)``).

The reference threads its caches through jitted programs as values; here
they are module state, so every forward, state swap and slot insert holds
``generation._model_lock`` of the model it touches: the worker's steps and
a router thread's ``prefill_handoff`` never interleave. The worker thread
enters ``torch.inference_mode`` and the model's CUDA device itself.

Restrictions: rope models only (an additive positional encoding tracks one
shared position), no beam search. Telemetry (``registry=``) and the chaos
injectors (``chaos=``) wait for later slices.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.models.generation import (
    _decode_modules, _model_lock, _PREFILL_STATE_KEYS, _shift_decode_pos,
    build_bucketed_prefill_fn, build_chunked_prefill_fns,
    clone_prefill_state, deserialize_prefill_state, load_prefill_state,
    partition_prefill_state, sample_token, serialize_prefill_state)
from bigdl_tpu_torch.models.lm_server import drain_queue, fail_requests
from bigdl_tpu_torch.models.prefix_cache import (DEFAULT_PREFIX_CACHE_MB,
                                                 prefix_cache_for)
from bigdl_tpu_torch.utils.device import (DeviceLike, check_module_device,
                                          module_device)
from bigdl_tpu_torch.utils.util import pow2_bucket

# Smallest prefill bucket (prefill_mode="bucketed"): shorter prompts share
# it. The top bucket saturates at max_len.
_PREFILL_BUCKET_LO = 16


@dataclass
class HandoffCursor:
    """What a peer replica needs to finish an interrupted request with the
    same greedy output: re-prefilling ``ids + emitted`` continues where
    the donor stopped."""
    ids: List[int]                      # the original prompt
    emitted: List[int]                  # tokens produced before the cut
    max_new: int                        # the original token budget


class ReplicaUnavailable(RuntimeError):
    """``submit()`` failed because this replica cannot serve. ``cursor``
    (when set) carries the accepted request's resume state; ``None`` means
    the request never entered this replica."""

    def __init__(self, message: str, cursor: Optional[HandoffCursor] = None):
        super().__init__(message)
        self.cursor = cursor


class ServerDraining(ReplicaUnavailable):
    """Planned unavailability (``drain()``): retry elsewhere."""


class ServerDead(ReplicaUnavailable):
    """Unplanned unavailability (a step or worker failure): the cache state
    is gone and this server will never serve again."""


@dataclass
class _Request:
    ids: List[int]
    max_new: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[int]] = None
    error: Optional[str] = None
    emitted0: List[int] = field(default_factory=list)  # resume-cursor prefix
    state_blob: Optional[bytes] = None  # shipped prefill partition
    handoff: Optional[HandoffCursor] = None
    fail_kind: Optional[str] = None     # "draining" | "dead" | None


class _Slot:
    __slots__ = ("req", "emitted", "new_count")

    def __init__(self, req):
        self.req = req
        self.emitted: List[int] = []
        self.new_count = 0


def _insert_state(big: list, small: list, slot: int, plen: int) -> None:
    """Copy a prefilled b=1 state into row ``slot`` of the continuous state
    (reference ``_build_insert_fn``): each cache row takes the b=1 cache cut
    to the row's length (the chunked template is padded to whole chunks; a
    speculative row is ``spec_len + 1`` longer than the template, and its
    tail stays behind the position mask), and ``decode_pos[slot] = plen``."""
    n = len(_PREFILL_STATE_KEYS)
    for i, (bg, sm) in enumerate(zip(big, small)):
        if _PREFILL_STATE_KEYS[i % n] == "decode_pos":
            bg[slot] = plen
        else:
            length = min(bg.shape[1], sm.shape[1])
            bg[slot, :length] = sm[0, :length]


class _PrefillPipeline:
    """The out-of-band b=1 admission prefill of ONE model (the target, and
    in speculative mode the draft): the b=1 template, the prefill
    functions, the prefix trie, and the ``single_mode`` context that swaps
    the b=1 state into the modules."""

    def __init__(self, model, *, mode: str, chunk: int, slots: int,
                 max_len: int, big_len: int, prefix_bytes: int = 0):
        mhas, pes, heads = _decode_modules(model)
        if pes:
            raise ValueError(
                "continuous batching requires a rope model (additive "
                "positional encodings track one shared position; "
                "build_lm(rope=True))")
        self.model = model
        self.mhas, self.heads = mhas, heads
        self.mode, self.chunk, self.max_len = mode, chunk, max_len
        self.device = module_device(model)
        model.evaluate_mode()
        # the chunked template is padded to whole chunks, so that a ragged
        # final chunk's pad writes stay inside it
        self.cache_len = (-(-max_len // chunk) * chunk if mode == "chunked"
                          else max_len)
        with _model_lock(model), torch.inference_mode():
            for m in mhas:
                m.enable_decode(1, self.cache_len)
            for m in heads:
                m.enable_decode()
            if mode == "chunked":
                self.chunk_fn, self.last_fn, self.state0 = \
                    build_chunked_prefill_fns(model)
                self.bucket_fn = None
            else:
                self.bucket_fn = build_bucketed_prefill_fn(model)
                self.state0 = clone_prefill_state(
                    partition_prefill_state(model))
            for m in mhas:
                m.enable_decode(slots, big_len, continuous=True)
        # the trie rides on the model, so that a new server over the same
        # weights starts warm; bucketed prefill has no chunk boundaries
        self.prefix = (prefix_cache_for(model, chunk=chunk,
                                        cache_len=self.cache_len,
                                        max_bytes=prefix_bytes)
                       if mode == "chunked" and prefix_bytes > 0 else None)

    @contextlib.contextmanager
    def single_mode(self, prefilled: bool, all_logits: bool = False):
        """Swap the modules to b=1 decode for a prefill, and back.

        ``prefilled`` selects the attention branch: True the warm-cache
        masked chunk (chunked prefill; right on a cold cache too), False the
        cold causal prefill (bucketed). ``all_logits`` makes the heads emit
        every position. The continuous state is put back on exit. The
        caller holds the model lock."""
        big = partition_prefill_state(self.model)
        for m in self.mhas:
            m._continuous = False
            m._decode_prefilled = prefilled
        if all_logits:
            for h in self.heads:
                h._decode_all = True
        try:
            yield
        finally:
            load_prefill_state(self.model, big)
            for m in self.mhas:
                m._continuous = True
                m._decode_prefilled = True
            for h in self.heads:
                h._decode_all = False

    def _prefill_chunked(self, ids: List[int]):
        """ceil((P-1)/C) chunks from the deepest prefix hit on, the final one
        right-padded, then one step for the last prompt token. Each FULL
        chunk's state is offered to the trie before the next chunk writes
        it in place."""
        c = self.chunk
        n = len(ids) - 1        # the last token runs as the sampling step
        hit, state = 0, None
        if self.prefix is not None:
            hit, state = self.prefix.match(ids[:n])
        if state is None:
            state = clone_prefill_state(self.state0)
        n_pad = -(-n // c) * c
        # the whole prompt crosses to the device once: the chunks and the
        # last token are views of one buffer (pad id 1: any valid id)
        host = np.ones(n_pad + 1, np.int64)
        host[:n] = ids[:n]
        host[-1] = ids[-1]
        toks = torch.as_tensor(host, device=self.device)[None]
        for start in range(hit, n, c):
            valid = min(c, n - start)
            state = self.chunk_fn(state, toks[:, start:start + c],
                                  start + valid)
            if self.prefix is not None and valid == c:
                # a ragged chunk is never cached: resuming inside a chunk
                # would regroup the tail's sums
                self.prefix.put(ids[:start + valid], state)
        lp, state = self.last_fn(state, toks[:, n_pad:])
        return lp, state, hit

    def _prefill_bucketed(self, ids: List[int]):
        """The prompt right-padded to its power-of-two bucket, one cold
        causal prefill, the log-probs of the true last token."""
        plen = len(ids)
        cap = self.cache_len
        bsz = pow2_bucket(plen, min(_PREFILL_BUCKET_LO, cap), cap)
        host = np.ones((1, bsz), np.int64)
        host[0, :plen] = ids
        prompt = torch.as_tensor(host, device=self.device)
        lp, state = self.bucket_fn(clone_prefill_state(self.state0), prompt,
                                   plen - 1)
        return lp, state, 0

    def run(self, ids: List[int]):
        """``(last-token log-probs (1, V), b=1 state, prefix-hit depth)``."""
        with _model_lock(self.model), torch.inference_mode():
            if self.mode == "bucketed":
                with self.single_mode(prefilled=False, all_logits=True):
                    return self._prefill_bucketed(ids)
            with self.single_mode(prefilled=True):
                return self._prefill_chunked(ids)

    def disable(self):
        with _model_lock(self.model):
            for m in self.mhas + self.heads:
                m.disable_decode()


class ContinuousLMServer:
    """Slot-scheduled continuous-batching server over one rope LM.

    ``submit()`` blocks until its request is done and returns the
    continuation ids (eos kept). Thread-safe; one worker thread owns the
    decode loop. Sampling draws from two generators on the model's device
    seeded from ``seed``: one for admissions, one for steps (the
    reference's disjoint ``fold_in(seed, 0/1)`` streams; the draws differ
    from JAX's, so only greedy output matches the reference token for
    token)."""

    def __init__(self, model, *, slots: int = 8, max_len: int = 256,
                 decode_block: int = 8, max_new_tokens: int = 64,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, greedy: bool = False,
                 eos_id: Optional[int] = None, seed: int = 0,
                 registry=None, prefill_mode: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 draft=None, spec_len: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_cache_mb: Optional[float] = None,
                 chaos=None, device: DeviceLike = "cuda"):
        if registry is not None:
            raise NotImplementedError("serving telemetry (registry=) is not "
                                      "ported yet (ROADMAP A.5)")
        if chaos is not None:
            raise NotImplementedError("the serving chaos injectors (chaos=) "
                                      "are not ported yet (ROADMAP A.1, with "
                                      "the router)")
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.device = check_module_device(model, device)
        mode = (prefill_mode if prefill_mode is not None
                else os.environ.get("BIGDL_PREFILL_MODE", "chunked"))
        if mode not in ("chunked", "bucketed"):
            raise ValueError(f"prefill_mode must be 'chunked' or "
                             f"'bucketed', got {mode!r}")
        chunk = int(prefill_chunk if prefill_chunk is not None
                    else os.environ.get("BIGDL_PREFILL_CHUNK", "128"))
        if chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        # a chunk wider than the cache buys nothing: clamp, as the reference
        chunk = min(chunk, max_len)
        self.prefill_mode = mode
        self.prefill_chunk = chunk
        self.draft = draft
        if draft is not None:
            if draft is model:
                raise ValueError(
                    "draft must be a separate module instance (one module "
                    "cannot hold two decode states at once)")
            if not greedy:
                raise ValueError(
                    "speculative serving is greedy-only: acceptance is "
                    "exact argmax match against the target, which keeps "
                    "outputs equal to non-speculative decode")
            check_module_device(draft, device)
            k = int(spec_len if spec_len is not None
                    else os.environ.get("BIGDL_SPEC_LEN", "4"))
            if k < 1:
                raise ValueError("spec_len must be >= 1")
            self.spec_len = k
        else:
            self.spec_len = 0
        if prefix_cache is None:
            prefix_cache = os.environ.get(
                "BIGDL_PREFIX_CACHE", "1").lower() not in (
                    "0", "off", "false", "no")
        mb = float(prefix_cache_mb if prefix_cache_mb is not None
                   else os.environ.get("BIGDL_PREFIX_CACHE_MB",
                                       str(DEFAULT_PREFIX_CACHE_MB)))
        prefix_bytes = (int(mb * (1 << 20))
                        if (prefix_cache and mode == "chunked") else 0)
        self.prefix_cache_enabled = prefix_bytes > 0
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.decode_block = max(1, int(decode_block))
        self.max_new_tokens = max_new_tokens
        self.sampling = dict(temperature=temperature, top_k=top_k,
                             top_p=top_p, greedy=greedy)
        self.eos_id = eos_id
        seeds = np.random.SeedSequence(seed).spawn(2)
        self._admit_gen = torch.Generator(device=self.device).manual_seed(
            int(seeds[0].generate_state(1)[0]))
        self._step_gen = torch.Generator(device=self.device).manual_seed(
            int(seeds[1].generate_state(1)[0]))
        self._steps = 0
        self._n_served = 0
        self._n_admitted = 0
        #: speculative rounds: draft tokens proposed to live rows, and how
        #: many of them the target accepted (the bonus token not counted)
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0

        # a speculative row carries spec_len + 1 entries of slack: a request
        # ending at max_len still runs a last verification chunk whose
        # writes reach spec_len entries past its last token
        big_len = max_len + (self.spec_len + 1 if draft is not None else 0)
        self._pipeline = _PrefillPipeline(
            model, mode=mode, chunk=chunk, slots=slots, max_len=max_len,
            big_len=big_len, prefix_bytes=prefix_bytes)
        self._heads = self._pipeline.heads
        self._d_pipeline = (_PrefillPipeline(
            draft, mode=mode, chunk=chunk, slots=slots, max_len=max_len,
            big_len=big_len, prefix_bytes=prefix_bytes)
            if draft is not None else None)

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._dead: Optional[str] = None     # set once; never cleared
        self._draining: Optional[str] = None  # set once; distinct from dead
        self._lifecycle_lock = threading.Lock()
        # the slot table is touched by the worker and by close()/drain()
        self._state_lock = threading.Lock()
        self._free = list(range(slots))
        self._active: dict = {}          # slot -> _Slot
        self._last_tok = torch.ones(slots, dtype=torch.int64,
                                    device=self.device)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="lm-server-continuous")
        self._worker.start()

    # ------------------------------------------------------------ client API
    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None,
               timeout: Optional[float] = None, *,
               emitted: Optional[List[int]] = None,
               state: Optional[bytes] = None) -> List[int]:
        """Serve one prompt. ``emitted`` resumes a request from its
        ``HandoffCursor``: the server re-prefills ``prompt + emitted`` and
        the result includes the resumed prefix. ``state`` admits a prefill
        partition shipped by ``prefill_handoff`` instead of prefilling."""
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("empty prompt")
        max_new = int(self.max_new_tokens if max_new_tokens is None
                      else max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(ids) + max_new > self.max_len:
            raise ValueError(f"prompt {len(ids)} + max_new {max_new} "
                             f"exceeds the server max_len {self.max_len}")
        emitted0 = [int(t) for t in (emitted or [])]
        if emitted0:
            # a cursor that already met its budget (or hit eos) needs no
            # decode: the donor never delivered the result
            if self.eos_id is not None and self.eos_id in emitted0:
                return emitted0[:emitted0.index(self.eos_id) + 1][:max_new]
            if len(emitted0) >= max_new:
                return emitted0[:max_new]
        if state is not None and self.draft is not None:
            raise ValueError(
                "state handoff is incompatible with speculative serving "
                "(the draft replica's partition does not travel)")
        if self._dead is not None:
            raise ServerDead(f"server is dead: {self._dead}")
        if self._draining is not None:
            raise ServerDraining(f"server is draining: {self._draining}")
        if self._stop.is_set():
            raise RuntimeError("server is closed")
        req = _Request(ids, max_new)
        req.emitted0 = emitted0
        req.state_blob = state
        self._queue.put(req)
        if not req.done.is_set() and (self._dead is not None
                                      or self._draining is not None):
            # the worker stopped between the check and the enqueue; its
            # final sweep may have missed this request
            if self._dead is not None:
                self._fail_handoff(req, emitted0,
                                   f"server is dead: {self._dead}", "dead")
            else:
                self._fail_handoff(req, emitted0,
                                   f"server is draining: {self._draining}",
                                   "draining")
        if not req.done.wait(timeout):
            raise TimeoutError("decode did not complete in time")
        if req.error is not None:
            if req.fail_kind == "draining":
                raise ServerDraining(req.error, cursor=req.handoff)
            if req.fail_kind == "dead":
                raise ServerDead(req.error, cursor=req.handoff)
            raise RuntimeError(req.error)
        return req.result

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot."""
        return self._queue.qsize()

    @property
    def dead_reason(self) -> Optional[str]:
        """Why the worker stopped serving (None while healthy)."""
        return self._dead

    @property
    def drain_reason(self) -> Optional[str]:
        """Why the server stopped admitting (None unless draining)."""
        return self._draining

    @property
    def batches_served(self) -> int:
        """Requests completed (the reference's name)."""
        return self._n_served

    @property
    def requests_admitted(self) -> int:
        """Requests admitted into slots over the server's lifetime."""
        return self._n_admitted

    @property
    def decode_blocks(self) -> int:
        """Decode rounds started: blocks of ``decode_block`` steps, or
        speculative rounds."""
        return self._steps

    def drain(self, reason: str = "drain requested") -> None:
        """Graceful shutdown: stop admitting, stop the decode loop at the
        next block boundary, and hand every accepted but unfinished request
        off as a ``HandoffCursor`` raised to its ``submit()`` as
        ``ServerDraining``. Idempotent, and safe to race with ``close()``."""
        with self._lifecycle_lock:
            if self._dead is not None or self._draining is not None:
                return
            self._draining = reason
        self._stop.set()
        self._worker.join(timeout=10)
        self._sweep_stranded()

    def close(self):
        """Stop the worker, take the model out of decode mode and fail
        anything still pending. Idempotent."""
        self._stop.set()
        self._worker.join(timeout=10)
        for p in self._pipelines:
            p.disable()
        self._sweep_stranded()

    def prefill_handoff(self, prompt_ids,
                        emitted: Optional[List[int]] = None) -> bytes:
        """Run the admission prefill without taking a slot and return the
        serialized partition (last-token log-probs and b=1 state) for a
        decode replica's ``submit(..., state=blob)``."""
        ids = ([int(t) for t in prompt_ids]
               + [int(t) for t in (emitted or [])])
        if not ids:
            raise ValueError("empty prompt")
        if self._dead is not None:
            raise ServerDead(f"server is dead: {self._dead}")
        if self._draining is not None:
            raise ServerDraining(f"server is draining: {self._draining}")
        if self._d_pipeline is not None:
            raise ValueError("prefill handoff is incompatible with "
                             "speculative serving (the draft partition "
                             "does not travel)")
        lp, small, _ = self._pipeline.run(ids)
        return serialize_prefill_state(lp, small)

    # --------------------------------------------------------------- engine
    @property
    def _pipelines(self):
        return ([self._pipeline] if self._d_pipeline is None
                else [self._pipeline, self._d_pipeline])

    @contextlib.contextmanager
    def _models_locked(self):
        """The model lock of the target and, in speculative mode, the
        draft, taken in a fixed order."""
        with contextlib.ExitStack() as stack:
            for m in sorted((p.model for p in self._pipelines), key=id):
                stack.enter_context(_model_lock(m))
            yield

    def _restore_handoff(self, blob: bytes):
        """A shipped prefill partition, checked against this server's own
        template and moved to its device and cache dtype."""
        lp, state = deserialize_prefill_state(blob)
        want = self._pipeline.state0
        if len(state) != len(want):
            raise ValueError(f"handoff partition has {len(state)} entries; "
                             f"this server's prefill template has "
                             f"{len(want)}")
        out = []
        for i, (got, ref) in enumerate(zip(state, want)):
            if torch.is_tensor(ref):
                if not torch.is_tensor(got) or got.shape != ref.shape:
                    raise ValueError(
                        f"handoff entry {i} has shape "
                        f"{tuple(getattr(got, 'shape', ()))}, the template "
                        f"expects {tuple(ref.shape)} (mismatched prefill "
                        "mode or chunk between the replicas?)")
                got = got.to(device=ref.device, dtype=ref.dtype)
            out.append(got)
        return lp.to(self.device), out

    def _admit(self, req: _Request) -> bool:
        # the context the caches must hold: the prompt plus any resumed
        # cursor prefix
        plen = len(req.ids) + len(req.emitted0)
        try:
            d_small = None
            if req.state_blob is not None:
                lp, small = self._restore_handoff(req.state_blob)
            else:
                lp, small, _ = self._pipeline.run(req.ids + req.emitted0)
                if self._d_pipeline is not None:
                    _, d_small, _ = self._d_pipeline.run(
                        req.ids + req.emitted0)
            self._n_admitted += 1
            tok = int(sample_token(lp, self._admit_gen, **self.sampling)[0])
            # peek, insert, then pop: an insert failure must not leak the
            # slot
            with self._state_lock:
                slot = self._free[-1]
            with self._models_locked():
                _insert_state(partition_prefill_state(self.model), small,
                              slot, plen)
                if d_small is not None:
                    # the draft's row lands on the same plen, so both
                    # models enter the round at one position
                    _insert_state(partition_prefill_state(self.draft),
                                  d_small, slot, plen)
                self._last_tok[slot] = tok
            with self._state_lock:
                self._free.pop()
            sl = _Slot(req)
            sl.emitted = list(req.emitted0) + [tok]
            sl.new_count = len(req.emitted0) + 1
            if self._finish_if_done(slot, sl):
                return True
            with self._state_lock:
                self._active[slot] = sl
            return True
        except Exception as e:  # noqa: BLE001 -- fail the one request
            req.error = f"{type(e).__name__}: {e}"
            req.done.set()
            return False

    def _finish_if_done(self, slot: int, sl: _Slot) -> bool:
        eos = self.eos_id
        hit_eos = eos is not None and sl.emitted and sl.emitted[-1] == eos
        if hit_eos or sl.new_count >= sl.req.max_new:
            sl.req.result = sl.emitted[:sl.req.max_new]
            sl.req.done.set()
            self._n_served += 1
            with self._state_lock:
                self._active.pop(slot, None)
                self._free.append(slot)
            return True
        return False

    def _fail_handoff(self, req: _Request, emitted: List[int],
                      message: str, kind: str) -> None:
        """Fail one request with its resume cursor (host state, which
        survives any device-state loss); a request already completed or
        failed is left as it is."""
        if req.done.is_set():
            return
        req.handoff = HandoffCursor(ids=list(req.ids),
                                    emitted=list(emitted),
                                    max_new=req.max_new)
        req.fail_kind = kind
        req.error = message
        req.done.set()

    def _sweep_stranded(self) -> None:
        """Snapshot and clear every in-flight slot and queued request, then
        fail them: with handoff cursors when draining, plain errors on a
        close. Run by ``close()``, ``drain()`` and the worker's stop path;
        the snapshot under ``_state_lock`` fails each request once."""
        with self._state_lock:
            stranded = list(self._active.items())
            self._active.clear()
            self._free.extend(s for s, _ in stranded)
        queued = drain_queue(self._queue)
        draining = self._draining
        if draining is not None:
            msg = f"server draining: {draining}"
            for _s, sl in stranded:
                self._fail_handoff(sl.req, sl.emitted, msg, "draining")
            for req in queued:
                self._fail_handoff(req, req.emitted0, msg, "draining")
        else:
            fail_requests([sl.req for _s, sl in stranded],
                          "server closed mid-generation")
            fail_requests(queued,
                          "server closed before the request was dispatched")

    def _die(self, reason: str) -> None:
        """Dead-server state: fail every in-flight and queued request now,
        each with its ``HandoffCursor``, and make later ``submit()``s raise
        at once. Never cleared: a failed step leaves the caches in an
        unknown state."""
        self._dead = reason
        with self._state_lock:
            stranded = list(self._active.items())
            self._active.clear()
            self._free.extend(slot for slot, _ in stranded)
        for _s, sl in stranded:
            self._fail_handoff(sl.req, sl.emitted,
                               f"server died: {reason}", "dead")
        for req in drain_queue(self._queue):
            self._fail_handoff(req, req.emitted0,
                               f"server is dead: {reason}", "dead")

    def _run(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                self._serve_loop()
            # the client-side sweep runs after a bounded join: fail what
            # this loop may have dequeued after it
            self._sweep_stranded()
        except Exception as e:  # noqa: BLE001 -- the worker-thread boundary
            self._die(f"{type(e).__name__}: {e}")

    def _step(self) -> np.ndarray:
        """One block of ``decode_block`` single-token steps over every slot;
        the (slots, block) tokens reach the host in one copy."""
        with self._models_locked():
            tok = self._last_tok
            toks = []
            for _ in range(self.decode_block):
                lp = self.model(tok[:, None])
                tok = sample_token(lp[:, -1], self._step_gen, **self.sampling)
                toks.append(tok)
            self._last_tok = tok
            return torch.stack(toks, dim=1).cpu().numpy()

    def _spec(self):
        """One speculative round over every slot: ``spec_len + 1`` draft
        steps (the last one's output is dropped, its input write commits
        the last proposal's k/v), one verification forward of the target
        over the carried token and the proposals, per-row first-mismatch
        acceptance, and the per-row rollback of both caches. Acceptance is
        computed on the device; the host reads one array per round.
        Returns ((slots, spec_len + 1) tokens, (slots,) counts)."""
        k = self.spec_len
        with self._models_locked():
            toks = self._last_tok
            tok, props = toks, []
            for _ in range(k + 1):
                lp = self.draft(tok[:, None])
                tok = torch.argmax(lp[:, -1], dim=-1) + 1
                props.append(tok)
            d_props = torch.stack(props[:k], dim=1)            # (slots, k)
            chunk = torch.cat([toks[:, None], d_props], dim=1)
            for h in self._heads:
                h._decode_all = True
            try:
                lp = self.model(chunk)
            finally:
                for h in self._heads:
                    h._decode_all = False
            g = torch.argmax(lp, dim=-1) + 1                    # (slots, k+1)
            match = d_props == g[:, :k]
            # accepted proposals: the run of matches before the first miss
            n_acc = match.to(torch.int64).cumprod(dim=1).sum(dim=1)
            bonus = g.gather(1, n_acc[:, None])[:, 0]
            ar = torch.arange(k + 1, device=g.device)[None, :]
            props_pad = torch.cat([d_props, torch.zeros_like(d_props[:, :1])],
                                  dim=1)
            emit = torch.where(ar < n_acc[:, None], props_pad, bonus[:, None])
            n_emit = n_acc + 1
            # both models advanced by k + 1; each row rolls back to its own
            # accepted boundary
            delta = n_emit - (k + 1)
            _shift_decode_pos(self.model, delta)
            _shift_decode_pos(self.draft, delta)
            self._last_tok = bonus
            host = torch.cat([emit, n_emit[:, None]], dim=1).cpu().numpy()
        return host[:, :k + 1], host[:, k + 1]

    def _serve_loop(self):
        while not self._stop.is_set():
            # strict-FIFO admission into free slots
            while self._free:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                self._admit(req)
            if not self._active:
                try:
                    req = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._admit(req)
                continue
            # one decode round for every slot (free rows compute garbage)
            self._steps += 1
            counts = None
            try:
                if self.draft is not None:
                    toks, counts = self._spec()
                else:
                    toks = self._step()
            except Exception as e:  # noqa: BLE001 -- fail fast AND dead
                self._die(f"decode step failed: {type(e).__name__}: {e}")
                return
            if counts is not None:
                live = list(self._active)
                self.spec_proposed_tokens += self.spec_len * len(live)
                # the +1 of each row is the target's own token
                emitted = int(counts[live].sum())
                self.spec_accepted_tokens += emitted - len(live)
            eos = self.eos_id
            for slot, sl in list(self._active.items()):
                row = (toks[slot] if counts is None
                       else toks[slot][:counts[slot]])
                for t in row:
                    t = int(t)
                    sl.emitted.append(t)
                    sl.new_count += 1
                    if ((eos is not None and t == eos)
                            or sl.new_count >= sl.req.max_new):
                        break
                self._finish_if_done(slot, sl)
