"""Autoregressive generation for causal LMs (counterpart of
``bigdl_tpu/models/generation.py``).

The reference compiles the whole decode (prefill, a ``lax.scan`` over the
new tokens, sampling) into one XLA program. PyTorch runs it eagerly: one
forward over the prompt fills the KV caches (module state of every
``MultiHeadAttention``), then one single-token forward per new token.

Ported: ``filter_top_k``, ``filter_top_p``, ``sample_token`` (greedy, and
the fused top-k / Gumbel-max path), and ``generate`` with greedy,
temperature, top-k and top-p sampling, ``eos_id`` / ``pad_id``,
``repetition_penalty`` and ``min_new_tokens``. Beam search and the rolling
cache (ROADMAP A3) and ``mesh`` decoding (ROADMAP A6) raise
``NotImplementedError``.

Token ids are 1-based, as everywhere in the reference. Random draws come
from an explicit ``torch.Generator``: the same seed gives other samples
than the reference's ``jax.random`` keys.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from bigdl_tpu_torch.nn.attention import MultiHeadAttention, PositionalEncoding
from bigdl_tpu_torch.nn.linear import LMHead, TiedLMHead
from bigdl_tpu_torch.nn.module import Module
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
    if not mhas:
        raise ValueError("generate() needs a model with MultiHeadAttention "
                         "layers (see models.transformer.build_lm)")
    return mhas, pes, heads


def generate(model: Module, prompt, max_new_tokens: int, *,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             greedy: bool = False, eos_id: Optional[int] = None,
             pad_id: Optional[int] = None,
             repetition_penalty: float = 1.0, min_new_tokens: int = 0,
             num_beams: int = 0, mesh=None, rolling_cache: bool = False,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt``.

    ``prompt``: (B, S) or (S,) 1-based ids (tensor, array or list). Returns
    prompt + continuation, (B, S + max_new_tokens), on ``device``, which
    must be the model's. A row that emits ``eos_id`` is frozen: its later
    positions hold ``pad_id`` (default ``eos_id``). Sampling draws from
    ``generator`` (default: a generator seeded with 0 on ``device``)."""
    if num_beams > 1:
        raise NotImplementedError("beam search is not ported yet (ROADMAP A3)")
    if rolling_cache:
        raise NotImplementedError("the rolling KV cache is not ported yet "
                                  "(ROADMAP A3)")
    if mesh is not None:
        raise NotImplementedError("mesh decoding is not ported yet "
                                  "(ROADMAP A6)")
    if repetition_penalty <= 0:
        raise ValueError("repetition_penalty must be > 0")
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
    if generator is None and not greedy:
        generator = torch.Generator(device=dev).manual_seed(0)

    with _model_lock(model), torch.inference_mode():
        was_training = model.training
        try:
            model.evaluate_mode()
            for m in mhas:
                m.enable_decode(b, total)
            for m in pes + heads:
                m.enable_decode()
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
