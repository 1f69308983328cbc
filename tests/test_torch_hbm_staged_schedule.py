"""K7b's issue order and K7c's range layout, emulated on the CPU.

``csrc/hbm_roof.cu`` runs only on the card, so this file replays, in
Python, what each block of the two kernels issues, at the sizes the probe
gives them (1 GiB a copy, the sweep's chunks, slots, lags and deals, an
H100's persistent grid) and at the ragged sizes ``chip_smoke.py`` checks:

- ``staged_copy_kernel`` (K7b): fill n of a block goes to slot n mod nbuf
  and holds the chunk ``take(n)`` returns: for the dynamic deal the next
  value of a counter all blocks share (the blocks are interleaved in a
  seeded random order, as the card may run them), for the static deals
  ``first + n * step`` (round-robin: b, b + G, ...; contiguous: a run of
  whole chunks). The block primes ``nbuf`` fills; at step j it waits for
  fill j's mbarrier at parity ``(j // nbuf) & 1``, stores it in a bulk
  group and, after ``wait_group.read lag``, refills the slot of fill
  ``j - lag``. The model tracks each slot's contents, its mbarrier's fills
  and which store groups a ``wait_group.read`` has proved read.
- ``ranged_copy_kernel`` (K7c): block b copies tile ``b // nstreams`` of
  range ``b % nstreams``, one tile of threads x vecs 16-byte vectors.
"""

import random

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import hbm_roof
from bigdl_tpu_torch.scripts import roofline_hbm

GIB = 1 << 30
H100_SMS = 132
SMEM_PER_SM = 228 * 1024      # an H100 SM's shared memory
SMEM_PER_BLOCK = 1024 + 128   # reserved a block, and the mbarriers
MAX_BLOCKS_PER_SM = 32


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def h100_grid(chunk: int, nbuf: int) -> int:
    """K7b's persistent grid on an H100, as the occupancy calculator gives
    it: SMs times the blocks whose slots fit an SM's shared memory."""
    return H100_SMS * min(MAX_BLOCKS_PER_SM,
                          SMEM_PER_SM // (chunk * nbuf + SMEM_PER_BLOCK))


def block_chunks(b: int, blocks: int, nchunks: int, deal: str):
    """(first, step, count) of block b under a static deal, as the kernel
    computes them."""
    per = -(-nchunks // blocks)
    if deal == "contiguous":
        return b * per, 1, min(per, nchunks - b * per)
    return b, blocks, (nchunks - 1 - b) // blocks + 1 if b < nchunks else 0


class StagedBlock:
    """One block of ``staged_copy_kernel``, replayed step by step, with
    every hazard the kernel must avoid checked as it happens."""

    def __init__(self, nbytes16, chunk, nbuf, lag, take):
        self.nbytes16, self.chunk, self.nbuf, self.lag = (nbytes16, chunk,
                                                          nbuf, lag)
        self.nchunks = -(-nbytes16 // chunk)
        self.take = take                     # n -> the chunk of fill n
        self.fill_chunk = []                 # the chunk of each fill
        self.slot_chunk = [None] * nbuf      # the chunk a slot holds
        self.fills = [0] * nbuf              # fills issued to each mbarrier
        self.store_slot = []                 # slot read by each store group
        self.read_upto = 0                   # groups proved read by a wait
        self.loads, self.stores = [], []     # (offset, bytes)

    def span(self, c):
        off = c * self.chunk
        return off, min(self.chunk, self.nbytes16 - off)

    def load(self, s, c):
        assert s == len(self.fill_chunk) % self.nbuf
        # no store that reads this slot may still be reading it
        assert s not in self.store_slot[self.read_upto:], (
            f"a fill of slot {s} before its store has read it")
        self.fill_chunk.append(c)
        self.slot_chunk[s] = c
        self.fills[s] += 1
        self.loads.append(self.span(c))

    def wait_full(self, j, parity):
        s = j % self.nbuf
        assert self.slot_chunk[s] == self.fill_chunk[j], (
            f"slot {s} holds chunk {self.slot_chunk[s]}, not fill {j}'s")
        # fill j is the slot's newest, and the mbarrier phase it completes
        # has the parity waited on
        assert self.fills[s] - 1 == j // self.nbuf
        assert parity == (self.fills[s] - 1) & 1

    def store(self, s):
        self.store_slot.append(s)
        self.stores.append(self.span(self.slot_chunk[s]))

    def wait_read(self, n):
        self.read_upto = max(self.read_upto, len(self.store_slot) - n)

    def steps(self):
        """The kernel's code, line for line; yields after each step so
        that blocks sharing a counter can be interleaved."""
        nbuf, lag, n = self.nbuf, self.lag, 0
        while n < nbuf:
            c = self.take(n)
            if c >= self.nchunks:
                break
            self.load(n % nbuf, c)
            n += 1
            yield
        more = n == nbuf
        j = 0
        while j < n:
            refill = more and j >= lag
            nxt = self.take(n) if refill else self.nchunks
            self.wait_full(j, (j // nbuf) & 1)
            self.store(j % nbuf)
            if nxt < self.nchunks:
                self.wait_read(lag)
                self.load(n % nbuf, nxt)
                n += 1
            elif refill:
                more = False
            j += 1
            yield
        self.wait_read(0)    # wait_group 0: every store done
        assert self.read_upto == len(self.store_slot)


def replay_staged(nbytes, chunk, nbuf, lag, blocks, deal, seed=0):
    """Every block's loads and stores, the tail, and the counter's final
    value (None for a static deal) for one launch."""
    nbytes16 = nbytes // 16 * 16
    nchunks = -(-nbytes16 // chunk)
    counter = [0]

    def take_next(n):
        counter[0] += 1
        return counter[0] - 1

    def static_take(b):
        first, step, count = block_chunks(b, blocks, nchunks, deal)
        return lambda n: first + n * step if n < count else nchunks

    blks = [StagedBlock(nbytes16, chunk, nbuf, lag,
                        take_next if deal == "dynamic" else static_take(b))
            for b in range(blocks)]
    live = [blk.steps() for blk in blks]
    order = random.Random(seed)
    while live:   # one step of a random live block at a time
        i = order.randrange(len(live))
        try:
            next(live[i])
        except StopIteration:
            live[i] = live[-1]
            live.pop()
    loads = [sp for blk in blks for sp in blk.loads]
    stores = [sp for blk in blks for sp in blk.stores]
    tail = (nbytes16, nbytes - nbytes16)   # block 0's plain copy
    return loads, stores, tail, counter[0] if deal == "dynamic" else None


def assert_covers_once(spans, nbytes16):
    """The (offset, bytes) spans tile [0, nbytes16) with no gap or overlap,
    each a multiple of 16 bytes at a 16-byte offset."""
    spans = np.array(sorted(spans), dtype=np.int64).reshape(-1, 2)
    assert (spans[:, 0] % 16 == 0).all() and (spans[:, 1] % 16 == 0).all()
    assert (spans[:, 1] > 0).all()
    ends = spans[:, 0] + spans[:, 1]
    assert spans[0, 0] == 0 and ends[-1] == nbytes16
    assert (spans[1:, 0] == ends[:-1]).all()


# (bf16 values, chunk bytes, slots, blocks): chip_smoke.py's ragged cases
RAGGED = [(3 * 8192 + 5, 16384, 4, 1), (6 * 8192 + 100, 16384, 4, 1),
          (7 * 8192 + 1000, 16384, 3, 1), (2 ** 20 + 3, 49152, 4, 0),
          (2 ** 20, 16384, 2, 3), (5, 16, 2, 0)]


@pytest.mark.parametrize("chunk,nbuf,lag,deal", roofline_hbm.MANUAL_SWEEP)
def test_staged_sweep_point_at_one_gib(chunk, nbuf, lag, deal):
    blocks = h100_grid(chunk, nbuf)
    loads, stores, tail, taken = replay_staged(GIB, chunk, nbuf, lag, blocks,
                                               deal)
    assert_covers_once(loads, GIB)
    assert_covers_once(stores, GIB)
    assert tail == (GIB, 0)
    # each block of the dynamic deal stops at its first chunk past the end
    assert taken in (None, -(-GIB // chunk) + blocks)


@pytest.mark.parametrize("deal", hbm_roof.DEALS)
@pytest.mark.parametrize("n,chunk,nbuf,blocks", RAGGED)
def test_staged_ragged_sizes_at_every_lag(n, chunk, nbuf, blocks, deal):
    nbytes = 2 * n
    blocks = blocks or h100_grid(chunk, nbuf)
    for lag in range(nbuf):
        loads, stores, (tail_at, tail_bytes), _ = replay_staged(
            nbytes, chunk, nbuf, lag, blocks, deal, seed=lag)
        nbytes16 = nbytes // 16 * 16
        if nbytes16:
            assert_covers_once(loads, nbytes16)
            assert_covers_once(stores, nbytes16)
        else:
            assert loads == stores == []
        assert tail_at == nbytes16 and 0 <= tail_bytes < 16
        assert tail_at + tail_bytes == nbytes


@pytest.mark.parametrize("nbuf", [2, 4, 8, hbm_roof.MAX_NBUF])
def test_fewer_chunks_than_slots_and_every_lag(nbuf):
    # one block, chunk counts on both sides of nbuf, a short last chunk
    for nchunks in range(1, 2 * nbuf + 2):
        nbytes = nchunks * 256 - 48
        for lag in range(nbuf):
            for deal in hbm_roof.DEALS:
                loads, stores, _, _ = replay_staged(nbytes, 256, nbuf, lag,
                                                    1, deal)
                assert_covers_once(loads, nbytes // 16 * 16)
                assert_covers_once(stores, nbytes // 16 * 16)


@pytest.mark.parametrize("seed", range(4))
def test_dynamic_deal_under_other_interleavings(seed):
    # a few blocks racing for a counter over a ragged size, at every lag
    nbytes = 37 * 8192 + 22       # 75 chunks of 4 KiB, the last short
    for nbuf in (2, 4, 5):
        for lag in range(nbuf):
            loads, stores, _, taken = replay_staged(nbytes, 4096, nbuf, lag,
                                                    7, "dynamic", seed)
            assert_covers_once(loads, nbytes // 16 * 16)
            assert_covers_once(stores, nbytes // 16 * 16)
            assert taken == 75 + 7


def test_refilling_the_newest_stores_slot_is_caught():
    """The model catches a refill that does not wait for its store: a
    refill of the slot just stored, with no ``wait_group.read``, fails."""
    blk = StagedBlock(16 * 1024, 1024, 2, 0, lambda n: n)
    blk.load(0, 0)
    blk.load(1, 1)
    blk.wait_full(0, 0)
    blk.store(0)
    with pytest.raises(AssertionError, match="before its store has read it"):
        blk.load(0, 2)


def test_a_wrong_parity_is_caught():
    blk = StagedBlock(8 * 1024, 1024, 2, 1, lambda n: n)
    for _ in blk.steps():
        pass
    # fill 6 is slot 0's fourth (fills 0, 2, 4, 6): its phase has parity 1
    with pytest.raises(AssertionError):
        blk.wait_full(6, 0)
    blk.wait_full(6, 1)


def test_round_robin_keeps_the_chunks_in_flight_together():
    """At step j every block of the round-robin deal is within one row of G
    chunks of the others: the copies in flight sit on neighbouring
    addresses. The contiguous deal spreads them a run apart."""
    chunk, nbuf = 16384, 4
    blocks = h100_grid(chunk, nbuf)
    nchunks = GIB // chunk
    at_step = {deal: [block_chunks(b, blocks, nchunks, deal)
                      for b in range(blocks)]
               for deal in ("round_robin", "contiguous")}
    j = 10
    rr = [f + j * s for f, s, c in at_step["round_robin"] if j < c]
    co = [f + j * s for f, s, c in at_step["contiguous"] if j < c]
    assert max(rr) - min(rr) < blocks
    assert max(co) - min(co) > 50 * blocks


def ranged_tiles(nstreams: int, span: int, threads: int, vecs: int):
    """(range, first vector, vectors) of every block of one K7c launch."""
    tile = threads * vecs
    per_range = hbm_roof.direct_blocks_per_range(span * 8, threads, vecs)
    out = []
    for b in range(nstreams * per_range):
        r, t = b % nstreams, b // nstreams
        lo = t * tile
        out.append((r, lo, max(0, min(tile, span - lo))))
    return out, per_range


@pytest.mark.parametrize("total", [GIB, 1001 * 2048 + 1234])
@pytest.mark.parametrize("nstreams", roofline_hbm.DMA_STREAMS)
def test_direct_copy_blocks_cover_each_range_once(total, nstreams):
    rows, lanes = roofline_hbm.hbm_dma_shape(total, nstreams)
    span = rows * lanes // nstreams // 8      # 16-byte vectors a range
    threads, vecs = hbm_roof.DEFAULT_THREADS, hbm_roof.DEFAULT_VECS
    tiles, per_range = ranged_tiles(nstreams, span, threads, vecs)
    for r in range(nstreams):
        mine = sorted((lo, n) for rr, lo, n in tiles if rr == r and n)
        assert mine[0][0] == 0
        assert all(a[0] + a[1] == b[0] for a, b in zip(mine, mine[1:]))
        assert mine[-1][0] + mine[-1][1] == span
        # the stamped blocks: the range's first and last
        assert tiles[r] == (r, 0, min(threads * vecs, span))
        assert tiles[(per_range - 1) * nstreams + r][0] == r
    # neighbouring blocks take neighbouring ranges: all run side by side
    assert [t[0] for t in tiles[:nstreams]] == list(range(nstreams))


@pytest.mark.parametrize("threads,vecs", [(256, 4), (128, 1), (1024, 2)])
def test_a_direct_copy_tile_maps_its_threads_onto_its_vectors(threads, vecs):
    # i = tile * threads * vecs + j * threads + thread, as the kernel does
    i = (np.arange(vecs)[:, None] * threads + np.arange(threads)[None, :])
    assert np.array_equal(np.sort(i.ravel()), np.arange(threads * vecs))


def test_wrappers_refuse_a_lag_the_slots_cannot_hold():
    x = torch.zeros(4096, dtype=torch.bfloat16)
    for nbuf, lag in ((2, 2), (4, -1), (1, 1)):
        with pytest.raises(ValueError):
            hbm_roof.staged_copy(x, 256, nbuf, lag=lag)
    with pytest.raises(ValueError):
        hbm_roof.staged_copy(x, 256, 2, deal="striped")
    with pytest.raises(ValueError):    # stamps of the wrong size
        hbm_roof.direct_copy(x.reshape(4, 1024), 2,
                             stamps=torch.zeros(3, dtype=torch.int64))
    # every lag the slots hold is taken, and copies on the CPU
    for lag in range(4):
        assert torch.equal(hbm_roof.staged_copy(x, 256, 4, lag=lag), x)
