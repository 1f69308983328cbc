"""The port's prefix cache (``models/prefix_cache.py``) against the
reference's, on the CPU.

The trie is host logic: the same operations on the reference's
``PrefixCache`` and the port's must give the same hashes, depths, hits,
misses and evictions (snapshots of equal byte sizes on both sides). On the
serving path a prefix hit must give the cold prefill's bits: the same
last-token log-probs and the same greedy answers.
"""

import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.prefix_cache import PrefixCache as JaxPrefixCache
from bigdl_tpu.models.prefix_cache import rolling_hash as jax_rolling_hash
from bigdl_tpu_torch.models.prefix_cache import (PrefixCache,
                                                 prefix_cache_for,
                                                 rolling_hash)
from bigdl_tpu_torch.models.serving import ContinuousLMServer
from bigdl_tpu_torch.models.transformer import build_lm

torch.set_num_threads(1)

V = 1000
C = 4
LM = dict(embed_dim=64, num_heads=4, num_kv_heads=2, ffn_dim=128,
          num_layers=2, max_len=64, rope=True, activation="swiglu",
          norm="rms", bias=False, fused_head=True)


def _jax_state(tag, kb=1):
    return [jnp.full((kb * 256,), float(tag), jnp.float32)]


def _state(tag, kb=1):
    return [torch.full((kb * 256,), float(tag))]


@pytest.mark.parametrize("seed", range(4))
def test_rolling_hash_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 32001, int(rng.integers(0, 40))).tolist()
    b = rng.integers(1, 32001, int(rng.integers(1, 40))).tolist()
    assert rolling_hash(a) == jax_rolling_hash(a)
    assert rolling_hash(a + b) == jax_rolling_hash(a + b)
    # the trie-descent identity
    assert rolling_hash(b, rolling_hash(a)) == rolling_hash(a + b)


def test_rolling_hash_order_and_length():
    assert rolling_hash([]) == 0
    assert rolling_hash([0, 1]) != rolling_hash([1])
    assert rolling_hash([1, 2]) != rolling_hash([2, 1])
    assert rolling_hash([1]) != rolling_hash([1, 1])


@pytest.mark.parametrize("seed", range(3))
def test_operation_sequence_matches_reference(seed):
    """A seeded sequence of put and match calls under a budget of three
    one-KiB snapshots (some of two KiB, one of eight: refused) gives the
    reference's return values, boundaries and counters at every step."""
    rng = np.random.default_rng(seed)
    budget = 3 * _state(0)[0].nbytes
    ref, got = JaxPrefixCache(C, budget), PrefixCache(C, budget)
    # prefixes of four three-chunk sequences, two of which share a chunk
    bases = rng.integers(1, 50, (4, 3 * C)).tolist()
    bases[1][:C] = bases[0][:C]
    for _ in range(120):
        base = bases[int(rng.integers(len(bases)))]
        toks = base[:C * int(rng.integers(1, 4))]
        if rng.random() < 0.5:
            kb = int(rng.choice([1, 1, 1, 2, 8]))
            tag = float(rng.integers(100))
            assert got.put(toks, _state(tag, kb)) == \
                ref.put(toks, _jax_state(tag, kb))
        else:
            extra = rng.integers(1, 4, int(rng.integers(0, C))).tolist()
            d_ref, s_ref = ref.match(toks + extra)
            d_got, s_got = got.match(toks + extra)
            assert d_got == d_ref
            assert (s_got is None) == (s_ref is None)
            if s_got is not None:
                np.testing.assert_array_equal(s_got[0].numpy(),
                                              np.asarray(s_ref[0]))
        assert got.boundaries() == ref.boundaries()
        assert (got.hits, got.misses, got.evictions, got.nbytes) == \
            (ref.hits, ref.misses, ref.evictions, ref.nbytes)
    assert got.evictions > 0 and got.hits > 0


def test_chunk_boundary_splits():
    pc = PrefixCache(chunk=4, max_bytes=1 << 20)
    toks = list(range(1, 13))
    pc.put(toks[:4], _state(1))
    pc.put(toks[:8], _state(2))
    assert pc.boundaries() == [4, 8]
    depth, state = pc.match(toks[:6])
    assert depth == 4 and float(state[0][0]) == 1.0
    assert pc.match(toks[:11])[0] == 8
    assert pc.match(toks[:4] + [99, 98, 97, 96])[0] == 4
    assert pc.match(toks[:3]) == (0, None)
    with pytest.raises(ValueError, match="whole number of chunks"):
        pc.put([1, 2, 3], _state(1))


def test_match_returns_an_owned_copy_and_put_copies():
    pc = PrefixCache(chunk=2, max_bytes=1 << 20)
    live = _state(7) + [5]          # a state list carries int positions too
    pc.put([5, 6], live)
    live[0].zero_()                 # the next chunk writes the live state
    _, got = pc.match([5, 6])
    assert float(got[0][0]) == 7.0 and got[1] == 5
    got[0].zero_()                  # the consumer writes its copy in place
    _, again = pc.match([5, 6])
    assert float(again[0][0]) == 7.0


def test_refresh_is_copy_free_oversize_refused_newest_kept():
    one = _state(0)[0].nbytes
    pc = PrefixCache(chunk=2, max_bytes=int(1.5 * one))
    pc.put([1, 2], _state(1))
    assert pc.put([1, 2], _state(99)) == 0          # refresh, not replace
    assert float(pc.match([1, 2])[1][0][0]) == 1.0
    assert pc.put([3, 4], _state(2, kb=4)) == 0     # larger than the budget
    assert pc.match([3, 4]) == (0, None) and pc.evictions == 0
    assert pc.put([5, 6], _state(3)) == 1           # over budget together
    assert len(pc) == 1 and pc.match([5, 6])[0] == 2
    pc.clear()
    assert (len(pc), pc.nbytes) == (0, 0)


def test_prefix_cache_for_attaches_per_config_and_bounded():
    model = build_lm(V, **LM, device="cpu", seed=0)
    a = prefix_cache_for(model, chunk=4, cache_len=16, max_bytes=1 << 20)
    again = prefix_cache_for(model, chunk=4, cache_len=16, max_bytes=1 << 10)
    assert again is a and a.max_bytes == 1 << 10
    assert prefix_cache_for(model, chunk=8, cache_len=16,
                            max_bytes=1 << 20) is not a
    for i in range(8):
        prefix_cache_for(model, chunk=4, cache_len=32 + i, max_bytes=1 << 20)
    assert len(model.__dict__["_prefix_trie"]) <= 4


# ------------------------------------------------------------------ serving
SHARED = [(37 * i) % V + 1 for i in range(3 * C)]          # three chunks
PROMPTS = [
    SHARED + [7, 9],                # seeds the trie (miss)
    SHARED + [11, 5],               # hit at 3C, a new tail
    SHARED[:2 * C + 1],             # hit at 2C, one token of tail
    SHARED,                         # chunked portion 3C-1: hit at 2C
    SHARED[:C - 1],                 # shorter than a chunk: no hit
    list(reversed(SHARED)) + [2],   # no shared prefix
    SHARED + [7, 9],                # the seed again
]


@pytest.fixture(scope="module")
def served():
    """A model, its answers to PROMPTS with the prefix cache and without,
    and the two servers' prefill log-probs."""
    model = build_lm(V, **LM, device="cpu", seed=1).evaluate_mode()
    out = {"model": model}
    for cache in (True, False):
        srv = ContinuousLMServer(model, slots=2, max_len=48, greedy=True,
                                 decode_block=4, prefill_chunk=C,
                                 prefix_cache=cache, device="cpu")
        try:
            out[cache] = [srv.submit(p, 6, timeout=120) for p in PROMPTS]
            # the log-probs once more, each prompt against the warm trie
            out[cache, "lp"] = [srv._pipeline.run(p)[0] for p in PROMPTS]
            out[cache, "trie"] = srv._pipeline.prefix
        finally:
            srv.close()
    return out


def test_hits_are_bit_identical_to_cold_prefill(served):
    assert served[True] == served[False]
    for warm, cold in zip(served[True, "lp"], served[False, "lp"]):
        assert torch.equal(warm, cold)
    assert len({t for a in served[True] for t in a}) > 1   # not degenerate


def test_trie_reports_the_hit_geometries(served):
    pc = served[True, "trie"]
    assert served[False, "trie"] is None
    # first pass: prompts 1, 2, 3 and 6 hit; second pass: all but the
    # sub-chunk prompt
    assert (pc.hits, pc.misses) == (4 + 6, 3 + 1)
    assert pc.boundaries() == [4, 4, 8, 8, 12, 12]
    assert pc.evictions == 0


def test_trie_does_not_survive_deepcopy_or_pickle(served):
    model = served["model"]
    assert model.__dict__["_prefix_trie"]
    clone = copy.deepcopy(model)
    loaded = pickle.loads(pickle.dumps(model))
    for m in (clone, loaded):
        assert "_prefix_trie" not in m.__dict__
    assert "_prefix_trie" in model.__dict__
    srv = ContinuousLMServer(loaded, slots=2, max_len=48, greedy=True,
                             decode_block=4, prefill_chunk=C, device="cpu")
    try:
        assert srv.submit(PROMPTS[1], 6, timeout=120) == served[True][1]
    finally:
        srv.close()


def test_eviction_under_a_small_budget_keeps_serving():
    model = build_lm(V, **LM, device="cpu", seed=2).evaluate_mode()
    srv = ContinuousLMServer(model, slots=2, max_len=48, greedy=True,
                             prefill_chunk=C, prefix_cache_mb=0.05,
                             device="cpu")
    try:
        for s in range(6):      # disjoint two-chunk prefixes
            ids = [(s * 7 + i) % V + 1 for i in range(2 * C)]
            assert len(srv.submit(ids + [s + 1], 2, timeout=120)) == 2
        pc = srv._pipeline.prefix
        assert pc.evictions > 0 and pc.nbytes <= pc.max_bytes
    finally:
        srv.close()
