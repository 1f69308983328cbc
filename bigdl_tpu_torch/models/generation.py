"""Autoregressive generation for causal LMs (counterpart of
``bigdl_tpu/models/generation.py``).

The reference compiles the whole decode (prefill, a ``lax.scan`` over the
new tokens, sampling) into one XLA program. PyTorch runs it eagerly: one
forward over the prompt fills the KV caches (module state of every
``MultiHeadAttention``), then one single-token forward per new token.

Ported: ``filter_top_k``, ``filter_top_p``, ``sample_token`` (greedy, and
the fused top-k / Gumbel-max path), ``generate`` with greedy, temperature,
top-k and top-p sampling, ``eos_id`` / ``pad_id``, ``repetition_penalty``,
``min_new_tokens`` and beam search (``num_beams``, ``length_penalty``), and
``generate_speculative`` (B=1, greedy or rejection-sampled). The rolling
cache (ROADMAP A.1.4, after ``build_lm(window=)``) and ``mesh`` decoding
(ROADMAP A.4) raise ``NotImplementedError``.

Beam search keeps the reference's tie order: among equal scores the lower
(beam, token) index wins, as in ``jax.lax.top_k`` (a stable descending
sort here; ``torch.topk`` promises no order among ties).

The serving engine's prefill machinery (``models/serving.py``) is here as
plain functions over module state: the per-request state partition
(``partition_prefill_state`` / ``load_prefill_state``), its wire format
(``serialize_prefill_state`` / ``deserialize_prefill_state``), the
position rewinds (``_set_decode_pos``, ``_shift_decode_pos``) and the
chunked and bucketed b=1 prefill functions. The reference threads these
states through jitted programs; here the functions swap a state into the
modules, run the eager forward and read the state back, so the caller
holds ``_model_lock(model)`` around them.

Token ids are 1-based, as everywhere in the reference. Random draws come
from an explicit ``torch.Generator``: the same seed gives other samples
than the reference's ``jax.random`` keys.
"""

from __future__ import annotations

import contextlib
import io
import threading
import weakref
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.attention import MultiHeadAttention, PositionalEncoding
from bigdl_tpu_torch.nn.linear import LMHead, Linear, TiedLMHead
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.recurrent import TimeDistributed
from bigdl_tpu_torch.utils.device import DeviceLike, check_module_device

# one lock per model: generate() toggles decode state on the model, so two
# concurrent generations on one instance must not interleave
_LOCKS: "weakref.WeakKeyDictionary[Module, threading.RLock]" = (
    weakref.WeakKeyDictionary())
_LOCKS_GUARD = threading.Lock()


def _model_lock(model: Module) -> threading.RLock:
    with _LOCKS_GUARD:
        lock = _LOCKS.get(model)
        if lock is None:
            lock = _LOCKS[model] = threading.RLock()
        return lock


def filter_top_k(logprobs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest-probability tokens; the rest get -inf."""
    if k <= 0 or k >= logprobs.shape[-1]:
        return logprobs
    kth = torch.topk(logprobs, k, dim=-1).values[..., -1:]
    return logprobs.masked_fill(logprobs < kth, float("-inf"))


def filter_top_p(logprobs: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering over normalised log-probabilities: keep the
    smallest set of tokens whose mass reaches ``p`` (the argmax always)."""
    if p <= 0.0 or p >= 1.0:
        return logprobs
    sorted_lp = torch.sort(logprobs, dim=-1, descending=True).values
    probs = torch.exp(sorted_lp)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    thresh = torch.where(keep, sorted_lp, torch.full_like(sorted_lp, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return logprobs.masked_fill(logprobs < thresh, float("-inf"))


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    e = torch.empty(shape, device=device).exponential_(generator=generator)
    return -torch.log(e)


def sample_token(logprobs: torch.Tensor, generator: Optional[torch.Generator],
                 *, temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, greedy: bool = False) -> torch.Tensor:
    """One sampling step over (B, V) log-probs -> (B,) 1-based int64 ids.

    With ``top_k > 0`` the tail runs on the (B, k) candidates only: one
    top-k over V, then temperature, top-p and a Gumbel-max draw on k values
    (the same distribution as filter, renormalise, sample)."""
    if greedy:
        return torch.argmax(logprobs, dim=-1) + 1
    lp = logprobs.float()
    if top_k > 0 and top_k < lp.shape[-1]:
        vals, idx = torch.topk(lp, top_k, dim=-1)     # sorted, descending
        if temperature != 1.0:
            vals = vals / max(float(temperature), 1e-6)
        vals = torch.log_softmax(vals, dim=-1)
        if 0.0 < top_p < 1.0:
            probs = torch.exp(vals)
            keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
            vals = vals.masked_fill(~keep, float("-inf"))
        choice = torch.argmax(vals + _gumbel(vals.shape, generator, lp.device),
                              dim=-1)
        return torch.gather(idx, 1, choice[:, None])[:, 0] + 1
    if temperature != 1.0:
        lp = lp / max(float(temperature), 1e-6)
    lp = filter_top_p(torch.log_softmax(lp, dim=-1), top_p)
    return torch.argmax(lp + _gumbel(lp.shape, generator, lp.device), dim=-1) + 1


def _decode_modules(model: Module):
    mhas = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    pes = [m for m in model.modules() if isinstance(m, PositionalEncoding)]
    heads = [m for m in model.modules() if isinstance(m, (LMHead, TiedLMHead))]
    # a TimeDistributed is last-position-sliced only when it is plausibly
    # the vocab head (an inner Linear, exactly one instance): slicing one in
    # the middle of a network would corrupt generations
    tds = [m for m in model.modules() if isinstance(m, TimeDistributed)]
    if tds:
        if len(tds) > 1:
            raise ValueError(
                f"model has {len(tds)} TimeDistributed modules; generate() "
                "can only last-position-slice a single LM-head tail "
                "(TimeDistributed(Linear) as the vocab projection)")
        if isinstance(tds[0].inner, Linear):
            heads.append(tds[0])
    if not mhas:
        raise ValueError("generate() needs a model with MultiHeadAttention "
                         "layers (see models.transformer.build_lm)")
    return mhas, pes, heads


def generate(model: Module, prompt, max_new_tokens: int, *,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             greedy: bool = False, eos_id: Optional[int] = None,
             pad_id: Optional[int] = None,
             repetition_penalty: float = 1.0, min_new_tokens: int = 0,
             num_beams: int = 0, length_penalty: float = 1.0, mesh=None,
             rolling_cache: bool = False,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt``.

    ``prompt``: (B, S) or (S,) 1-based ids (tensor, array or list). Returns
    prompt + continuation, (B, S + max_new_tokens), on ``device``, which
    must be the model's. A row that emits ``eos_id`` is frozen: its later
    positions hold ``pad_id`` (default ``eos_id``). Sampling draws from
    ``generator`` (default: a generator seeded with 0 on ``device``).

    ``num_beams > 1`` is deterministic beam search (``_beam_search``): the
    best beam per row under the GNMT length penalty
    ``score / len ** length_penalty``; it does not compose with the
    stochastic filters, ``repetition_penalty`` or ``min_new_tokens``."""
    if rolling_cache:
        raise NotImplementedError("the rolling KV cache is not ported yet "
                                  "(ROADMAP A.1.4, after build_lm(window=), "
                                  "A.2)")
    if mesh is not None:
        raise NotImplementedError("mesh decoding is not ported yet "
                                  "(ROADMAP A.4)")
    if num_beams > 1 and (top_k or top_p):
        raise ValueError("beam search is deterministic; top_k/top_p do not "
                         "compose with num_beams")
    if num_beams > 1 and (repetition_penalty != 1.0 or min_new_tokens):
        raise ValueError("repetition_penalty/min_new_tokens apply to the "
                         "sampling path, not beam search")
    if repetition_penalty <= 0:
        raise ValueError("repetition_penalty must be > 0")
    if any(m._continuous for m in _decode_modules(model)[0]):
        raise ValueError("the model is being served by a ContinuousLMServer "
                         "(its caches hold the slots); close the server or "
                         "generate with another instance")
    if num_beams == 1:
        greedy = True  # width-1 beam search is greedy decoding
    dev = check_module_device(model, device)
    prompt = torch.as_tensor(prompt, device=dev)
    squeeze = prompt.dim() == 1
    if squeeze:
        prompt = prompt[None]
    if max_new_tokens <= 0:
        return prompt[0] if squeeze else prompt
    b, s0 = prompt.shape
    total = s0 + max_new_tokens
    mhas, pes, heads = _decode_modules(model)
    for pe in pes:
        if pe.pos_table().shape[0] < total:
            raise ValueError(
                f"model max_len {pe.pos_table().shape[0]} < prompt + "
                f"max_new_tokens {total}; rebuild with a larger max_len")
    if pad_id is None:
        pad_id = eos_id if eos_id is not None else 1
    if generator is None and not greedy and num_beams <= 1:
        generator = torch.Generator(device=dev).manual_seed(0)

    with _model_lock(model), torch.inference_mode():
        was_training = model.training
        try:
            model.evaluate_mode()
            for m in mhas:
                m.enable_decode(b, total)
            for m in pes + heads:
                m.enable_decode()
            if num_beams > 1:
                toks = _beam_search(model, mhas, prompt, max_new_tokens,
                                    int(num_beams), float(length_penalty),
                                    eos_id, pad_id)
            else:
                toks = _decode(model, prompt, max_new_tokens, generator,
                               dict(temperature=temperature, top_k=top_k,
                                    top_p=top_p, greedy=greedy),
                               eos_id, pad_id, float(repetition_penalty),
                               int(min_new_tokens))
        finally:
            for m in mhas + pes + heads:
                m.disable_decode()
            model.train(was_training)
    out = torch.cat([prompt, toks.to(prompt.dtype)], dim=1)
    return out[0] if squeeze else out


def _decode(model, prompt, max_new_tokens, generator, sampling, eos_id,
            pad_id, rep, min_new):
    """Prefill, then one forward per token; returns (B, max_new) ids."""
    b = prompt.shape[0]
    out = model(prompt)
    v = out.shape[-1]
    rows = torch.arange(b, device=prompt.device)
    seen = None
    if rep != 1.0:
        seen = torch.zeros((b, v), dtype=torch.bool, device=prompt.device)
        idx0 = (prompt.to(torch.int64) - 1).clamp(0, v - 1)
        seen[rows[:, None], idx0] = True

    def sample(logp, t):
        if seen is not None:
            # CTRL-style: log-probs are negative, so a penalty > 1 on a seen
            # token's log-prob pushes it down
            logp = torch.where(seen, logp * rep, logp)
        if eos_id is not None and t < min_new:
            logp = logp.clone()
            logp[:, eos_id - 1] = float("-inf")
        return sample_token(logp, generator, **sampling)

    tok = sample(out[:, -1].float(), 0)
    done = (tok == eos_id) if eos_id is not None else None
    toks = [tok]
    for t in range(1, max_new_tokens):
        if seen is not None:
            seen[rows, tok - 1] = True
        out = model(tok[:, None].to(prompt.dtype))
        nxt = sample(out[:, -1].float(), t)
        if done is not None:
            nxt = nxt.masked_fill(done, pad_id)
            done = done | (nxt == eos_id)
        tok = nxt
        toks.append(tok)
    return torch.stack(toks, dim=1)


def _top_n(x: torch.Tensor, n: int):
    """``jax.lax.top_k`` over the last axis: the n largest values, sorted
    descending, the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def _reorder_caches(mhas, index: torch.Tensor) -> None:
    """Every KV cache row i becomes row ``index[i]``: a gather into fresh
    tensors (never an in-place copy of a cache from itself). Only the
    buffers are swapped, so ``decode_pos`` and ``_decode_prefilled``
    stay."""
    for m in mhas:
        for name in ("k_cache", "v_cache"):
            m._buffers[name] = torch.index_select(m._buffers[name], 0, index)


def _beam_search(model, mhas, prompt, max_new_tokens: int, num_beams: int,
                 length_penalty: float, eos_id, pad_id: int) -> torch.Tensor:
    """Batched beam search over the KV caches (reference
    ``_build_beam_fn``); returns the best beam's (B, max_new) ids.

    One prefill at batch B, then every cache is tiled to B x num_beams
    (batch-major: the beams of item i are contiguous). Each step scores all
    (beam, token) continuations, keeps the top ``num_beams`` per item and
    reorders every cache by each survivor's parent beam. A finished beam
    (it emitted ``eos_id``) is frozen: its only continuation is ``pad_id``
    at unchanged score. Filler beams (width above the vocabulary) start at
    -inf, frozen."""
    n = num_beams
    b = prompt.shape[0]
    dev = prompt.device
    logp0 = model(prompt)[:, -1].float()                   # (B, V)
    v = logp0.shape[-1]
    if eos_id is not None and not 1 <= pad_id <= v:
        raise ValueError(
            f"pad_id {pad_id} outside the vocab 1..{v}: frozen beams "
            "continue with pad_id, so it must be a real token id")
    k0 = min(n, v)
    scores, idx = _top_n(logp0, k0)                        # (B, k0)
    if k0 < n:
        scores = torch.cat([scores, torch.full((b, n - k0), float("-inf"),
                                               device=dev)], dim=1)
        idx = torch.cat([idx, torch.full((b, n - k0), pad_id - 1,
                                         dtype=idx.dtype, device=dev)], dim=1)
    tok = idx + 1
    done = (tok == eos_id) if eos_id is not None else torch.zeros_like(
        tok, dtype=torch.bool)
    if k0 < n:
        done = done | (torch.arange(n, device=dev)[None, :] >= k0)
    lengths = torch.ones((b, n), device=dev)
    _reorder_caches(mhas, torch.arange(b, device=dev).repeat_interleave(n))
    seqs = torch.zeros((b, n, max_new_tokens), dtype=torch.int64, device=dev)
    seqs[:, :, 0] = tok
    frozen = torch.full((v,), float("-inf"), device=dev)
    if eos_id is not None:
        frozen[pad_id - 1] = 0.0
    base = (torch.arange(b, device=dev) * n)[:, None]
    for t in range(1, max_new_tokens):
        out = model(tok.reshape(b * n, 1).to(prompt.dtype))
        logp = out[:, -1].float().reshape(b, n, v)
        if eos_id is not None:
            logp = torch.where(done[..., None], frozen, logp)
        total = scores[..., None] + logp                   # (B, n, V)
        scores, flat = _top_n(total.reshape(b, n * v), n)
        parent = flat // v                                 # (B, n)
        tok = flat % v + 1
        done = done.gather(1, parent)
        lengths = lengths.gather(1, parent) + (~done).float()
        seqs = seqs.gather(1, parent[..., None].expand(-1, -1,
                                                       max_new_tokens))
        seqs[:, :, t] = torch.where(done, torch.full_like(tok, pad_id), tok)
        if eos_id is not None:
            done = done | (tok == eos_id)
        _reorder_caches(mhas, (base + parent).reshape(-1))
    norm = scores / torch.pow(lengths.clamp(min=1.0), length_penalty)
    best = torch.argmax(norm, dim=1)                       # (B,)
    return seqs[torch.arange(b, device=dev), best]


def _retemp(lp: torch.Tensor, temperature: float) -> torch.Tensor:
    """Temperature-rescaled log-probs: dividing log-probs by T differs from
    logits / T by a constant, which the renormalisation removes."""
    if temperature == 1.0:
        return lp
    return torch.log_softmax(lp / temperature, dim=-1)


def _draw(lp: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of (R, V) log-probs: (R,) 1-based ids."""
    return torch.multinomial(torch.exp(lp.float()), 1,
                             generator=generator)[:, 0] + 1


def generate_speculative(target: Module, draft: Module, prompt,
                         max_new_tokens: int, *, spec_len: int = 4,
                         eos_id: Optional[int] = None,
                         pad_id: Optional[int] = None,
                         generator: Optional[torch.Generator] = None,
                         temperature: float = 1.0,
                         device: DeviceLike = "cuda") -> torch.Tensor:
    """Speculative decoding (reference ``generate_speculative``): the DRAFT
    proposes ``spec_len`` tokens a round, the TARGET verifies them in one
    warm-cache chunk of ``spec_len + 1``, and the accepted prefix is
    emitted plus one target-sourced token.

    - ``generator=None``: GREEDY. The longest run of proposals matching the
      target's argmax is accepted, plus the target's own next token (the
      bonus): the output is the target's greedy generation.
    - a ``torch.Generator``: SAMPLED (rejection-sampling speculative
      decoding). Proposals are drawn from the draft distribution q;
      proposal i is accepted with probability ``min(1, p_i(x)/q_i(x))``;
      the first rejection resamples from the residual ``max(p - q, 0)``
      renormalised (p itself when the residual sums to zero), and full
      acceptance draws the bonus from ``p_{k+1}``. The emitted tokens are
      distributed as sampling from the target alone. ``temperature``
      rescales both distributions.

    Each round the draft runs ``spec_len + 1`` single-token steps (the last
    one writes the last proposal into its cache), the host reads the
    accepted length once, and both caches rewind by a ``decode_pos`` reset.
    The caches hold ``prompt + max_new + spec_len + 2`` positions. B=1
    only; ``draft`` must be a separate module instance (a module holds one
    decode state); both models' locks are taken in ``id`` order.

    Returns (1, S + max_new_tokens) ids on ``device``; positions after an
    ``eos_id`` hold ``pad_id`` (default ``eos_id``)."""
    dev = check_module_device(target, device)
    check_module_device(draft, device)
    if draft is target:
        raise ValueError("draft must be a separate module instance (one "
                         "module cannot hold two decode states at once)")
    prompt = torch.as_tensor(prompt, device=dev)
    if prompt.dim() == 1:
        prompt = prompt[None]
    b, s0 = prompt.shape
    if b != 1:
        raise ValueError("speculative decoding is B=1 (per-row acceptance "
                         "lengths need per-row cache positions)")
    if spec_len < 1:
        raise ValueError("spec_len must be >= 1")
    if temperature <= 0:
        raise ValueError("temperature must be > 0")
    sampled = generator is not None
    k = int(spec_len)
    cap = s0 + max_new_tokens + k + 2   # slack for the over-appended chunk
    if pad_id is None:
        pad_id = eos_id if eos_id is not None else 1
    mods = {id(target): _decode_modules(target),
            id(draft): _decode_modules(draft)}
    for mhas, pes, _ in mods.values():
        if any(m._continuous for m in mhas):
            raise ValueError("a model is being served by a "
                             "ContinuousLMServer (its caches hold the "
                             "slots); close the server or use another "
                             "instance")
        for pe in pes:
            if pe.pos_table().shape[0] < cap:
                raise ValueError(
                    f"model max_len {pe.pos_table().shape[0]} < prompt + "
                    f"max_new + spec_len slack {cap}; rebuild with a "
                    "larger max_len")
    models = sorted((target, draft), key=id)
    with contextlib.ExitStack() as stack:
        for m in models:
            stack.enter_context(_model_lock(m))
        stack.enter_context(torch.inference_mode())
        modes = [m.training for m in models]
        try:
            for model in models:
                mhas, pes, heads = mods[id(model)]
                model.evaluate_mode()
                for m in mhas:
                    m.enable_decode(1, cap)
                for m in pes + heads:
                    m.enable_decode()
            out = _speculate(target, draft, mods[id(target)][2], prompt,
                             max_new_tokens, k, eos_id, sampled, generator,
                             float(temperature))
        finally:
            for model, mode in zip(models, modes):
                mhas, pes, heads = mods[id(model)]
                for m in heads:
                    m._decode_all = False
                for m in mhas + pes + heads:
                    m.disable_decode()
                model.train(mode)
    toks = (out + [pad_id] * max_new_tokens)[:max_new_tokens]
    cont = torch.as_tensor([toks], dtype=prompt.dtype, device=dev)
    return torch.cat([prompt, cont], dim=1)


def _speculate(target, draft, t_heads, prompt, max_new_tokens, k, eos_id,
               sampled, generator, temperature) -> List[int]:
    """The rounds of ``generate_speculative`` over prepared decode states;
    returns the emitted ids (eos kept, at least max_new_tokens unless an
    eos ended the run)."""
    s0 = prompt.shape[1]
    lp = _retemp(target(prompt)[:, -1].float(), temperature)
    cur = (_draw(lp, generator) if sampled
           else torch.argmax(lp, dim=-1) + 1)                # (1,)
    draft(prompt)
    for h in t_heads:
        h._decode_all = True      # verification reads every chunk position
    first = int(cur[0])
    out = [first]
    if eos_id is not None and first == eos_id:
        return out
    pos = s0
    while len(out) < max_new_tokens:
        tok, props, qs = cur, [], []
        for _ in range(k + 1):
            q = _retemp(draft(tok[:, None].to(prompt.dtype))[:, -1].float(),
                        temperature)
            tok = (_draw(q, generator) if sampled
                   else torch.argmax(q, dim=-1) + 1)
            props.append(tok)
            qs.append(q[0])
        d_props = torch.cat(props[:k])                       # (k,)
        chunk = torch.cat([cur, d_props])[None].to(prompt.dtype)
        t_lp = _retemp(target(chunk)[0].float(), temperature)  # (k+1, V)
        if sampled:
            q_all = torch.stack(qs)                          # (k+1, V)
            rows = torch.arange(k, device=d_props.device)
            p_tok = t_lp[rows, d_props - 1]
            q_tok = q_all[rows, d_props - 1]
            u = torch.rand(k, generator=generator, device=d_props.device)
            accept = torch.log(u) < (p_tok - q_tok)
            n_acc = accept.to(torch.int64).cumprod(0).sum()
            t_row = torch.exp(t_lp[n_acc])
            q_row = torch.exp(q_all[n_acc.clamp(max=k - 1)]) * (n_acc < k)
            res = torch.clamp(t_row - q_row, min=0.0)
            tot = res.sum()
            # p == q after rounding leaves an empty residual: the
            # conditional is then p itself
            probs = torch.where(tot > 0, res / tot.clamp(min=1e-38), t_row)
            bonus = torch.multinomial(probs, 1, generator=generator) + 1
        else:
            g = torch.argmax(t_lp, dim=-1) + 1               # (k+1,)
            n_acc = (d_props == g[:k]).to(torch.int64).cumprod(0).sum()
            bonus = g[n_acc][None]
        # the one host read of a round: the accepted length, the proposals
        # and the bonus
        host = torch.cat([n_acc[None], d_props, bonus]).tolist()
        n = host[0]
        emit = host[1:1 + n] + [host[-1]]
        if eos_id is not None and eos_id in emit:
            out += emit[:emit.index(eos_id) + 1]
            return out
        out += emit
        # both caches rewind to the accepted boundary: the rejected writes
        # lie past decode_pos and are written over by later rounds
        pos += n + 1
        _set_decode_pos(target, pos)
        _set_decode_pos(draft, pos)
        cur = bonus.reshape(1)
    return out


# ---------------------------------------------------------------------------
# The serving engine's prefill machinery
# ---------------------------------------------------------------------------

def _set_decode_pos(model: Module, value: int) -> None:
    """Set every ``decode_pos`` (attention caches and positional
    encodings) to ``value``: the chunked prefill's rewind past the pads of
    a ragged final chunk."""
    for m in model.modules():
        if isinstance(m, (MultiHeadAttention, PositionalEncoding)):
            m.decode_pos = (torch.full_like(m.decode_pos, value)
                            if torch.is_tensor(m.decode_pos) else value)


def _shift_decode_pos(model: Module, delta: torch.Tensor) -> None:
    """Add ``delta`` to every ``decode_pos``: with a (B,) tensor of
    non-positive offsets on a continuous cache, the per-row rollback of a
    speculative round (each slot to its own accepted boundary). The
    position tensor of a continuous ``enable_decode`` is updated in place,
    so that a CUDA graph of the round replays the rollback into the tensor
    the engine reads."""
    for m in model.modules():
        if isinstance(m, (MultiHeadAttention, PositionalEncoding)):
            if m.decode_pos is getattr(m, "_own_pos", None):
                m.decode_pos.add_(delta)
            else:
                m.decode_pos = m.decode_pos + delta


#: the per-request decode state of one attention module, in the order in
#: which the reference flattens its buffer tree (sorted keys)
_PREFILL_STATE_KEYS = ("decode_pos", "k_cache", "v_cache")


def _state_modules(model: Module) -> List[MultiHeadAttention]:
    """The model's attention modules in the reference's leaf order (its
    buffer tree flattens nested dicts by sorted key at every level)."""
    named = [(tuple(name.split(".")), m) for name, m in model.named_modules()
             if isinstance(m, MultiHeadAttention)]
    return [m for _, m in sorted(named, key=lambda t: t[0])]


def partition_prefill_state(model: Module) -> list:
    """The per-request decode state of ``model``: ``decode_pos`` (an int in
    b=1 mode, a (B,) tensor in continuous mode), ``k_cache`` and
    ``v_cache`` of every attention module, as a flat list of the live
    objects. Weights, a quantized model's int8 rows too, are not part of
    it and are never copied per request."""
    return [getattr(m, key) for m in _state_modules(model)
            for key in _PREFILL_STATE_KEYS]


def load_prefill_state(model: Module, state: list) -> None:
    """Install a ``partition_prefill_state`` list into the modules."""
    mhas = _state_modules(model)
    n = len(_PREFILL_STATE_KEYS)
    if len(state) != n * len(mhas):
        raise ValueError(f"state has {len(state)} entries; the model holds "
                         f"{n * len(mhas)}")
    for i, m in enumerate(mhas):
        m.decode_pos, k, v = state[n * i:n * i + n]
        m._buffers["k_cache"], m._buffers["v_cache"] = k, v


def serialize_prefill_state(lp: torch.Tensor, state: list) -> bytes:
    """Pack one admission handoff, the (1, V) last-token log-probs and a
    b=1 state partition, into an npz blob with the reference's keys
    (``lp``, ``s0..sN`` in partition order; ``decode_pos`` as a 0-d int32).
    bf16 tensors travel as f32, which holds them exactly; the receiver
    casts to its own cache dtype."""
    def host(x):
        if not torch.is_tensor(x):
            return np.asarray(x, np.int32)
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()

    buf = io.BytesIO()
    arrs = {"lp": host(lp)}
    for i, x in enumerate(state):
        arrs[f"s{i}"] = host(x)
    np.savez(buf, **arrs)
    return buf.getvalue()


def deserialize_prefill_state(data: bytes):
    """``(lp, state)`` from a ``serialize_prefill_state`` blob (the
    reference's too), on the CPU: 0-d integer entries come back as ints,
    the rest as tensors."""
    z = np.load(io.BytesIO(data))
    lp = torch.from_numpy(np.asarray(z["lp"], np.float32))
    n = sum(1 for k in z.files if k.startswith("s"))
    state = []
    for i in range(n):
        a = z[f"s{i}"]
        state.append(int(a) if a.ndim == 0 and a.dtype.kind in "iu"
                     else torch.from_numpy(np.array(a)))
    return lp, state


def clone_prefill_state(state: list) -> list:
    """An owned copy of a state partition: tensors cloned, ints as they
    are. The prefill functions write their state in place."""
    return [x.clone() if torch.is_tensor(x) else x for x in state]


def build_chunked_prefill_fns(model: Module):
    """The chunked b=1 prompt prefill (reference
    ``build_chunked_prefill_fns``), over the model's current b=1 decode
    state, which becomes the zero template. Returns ``(chunk_fn, last_fn,
    state0)``:

    - ``chunk_fn(state, chunk, new_pos) -> state``: one (1, C) chunk through
      the warm-cache masked branch of ``MultiHeadAttention._attend_decode``
      (the caller sets ``_decode_prefilled``; it is right on a cold cache,
      whose unwritten entries lie behind the position mask). k/v are
      written at ``decode_pos..decode_pos+C-1``; ``decode_pos`` is then set
      to ``new_pos``, the true token count, so the pads of a ragged final
      chunk are written over by the next call;
    - ``last_fn(state, tok) -> (lp, state)``: the prompt's last token as one
      step; its (1, V) log-probs are the admission's sample;
    - ``state0``: the template; pass the functions an owned copy
      (``clone_prefill_state``), which they write in place."""
    state0 = clone_prefill_state(partition_prefill_state(model))

    def chunk_fn(state, chunk, new_pos):
        load_prefill_state(model, state)
        model(chunk)
        _set_decode_pos(model, new_pos)
        return partition_prefill_state(model)

    def last_fn(state, tok):
        load_prefill_state(model, state)
        lp = model(tok)
        return lp[:, -1], partition_prefill_state(model)

    return chunk_fn, last_fn, state0


def build_bucketed_prefill_fn(model: Module):
    """The bucketed b=1 prompt prefill (reference
    ``build_bucketed_prefill_fn``): ``fn(state, prompt, last_idx) -> (lp,
    state)`` runs the cold causal prefill of a prompt right-padded to its
    bucket (kernel K1 on the card) and reads the log-probs of the true last
    token at ``last_idx``; the heads must be in ``_decode_all`` mode."""
    def fn(state, prompt, last_idx):
        load_prefill_state(model, state)
        lp = model(prompt)
        return lp[:, last_idx], partition_prefill_state(model)

    return fn
