"""The port's HBM streaming probes against the JAX package's, on the CPU.

The K7 kernels' plain versions (``bigdl_tpu_torch/ops/hbm_roof.py``, what
the CPU runs) against the Pallas kernels of ``scripts/roofline_pallas.py``
run in interpret mode: ``_copy_kernel``, ``_read_kernel`` and
``_triad_kernel`` with ``bench_auto``'s block specs, ``_manual_copy_body``
and ``bench_hbm_dma``'s kernel with the TPU interpreter, on seeded N(0, 1)
bf16 inputs at even and ragged sizes. Then the probe's ``bench_*``
functions against the reference's, both driven with their timer replaced
by one fixed time: the same GB/s for the same total bytes (the byte
accounting is the reference's) and the same outputs of a two-pass chain.

Tolerances. Copies are bit-identical. triad: bit-identical or one bf16
step, where both compute a + 2b in f32 (exact for bf16 inputs up to one
rounding) and round once. read: within 1e-6 of sum|x|, f32 sums in
another order.
"""

import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bigdl_tpu_torch.ops import hbm_roof
from bigdl_tpu_torch.scripts import roofline_hbm

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
READ_RTOL = 1e-6
FIXED_S = 1e-8     # the timer of both sides: keeps digits after round(, 1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    """``scripts/roofline_pallas.py`` loaded the way its CLI runs it."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    spec = importlib.util.spec_from_file_location(
        "roofline_pallas", os.path.join(SCRIPTS, "roofline_pallas.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(shape, seed):
    """Seeded N(0, 1) values, rounded to bf16, as (jax array, torch tensor)."""
    x = jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(
        np.float32)).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


def _torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between a and b in bf16 steps."""
    def ordered(t):
        u = t.view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - u, u)
    return int((ordered(a) - ordered(b)).abs().max())


# (rows, lanes, blocks): a (blocks * rows, lanes) array in (rows, lanes)
# blocks, as bench_auto cuts it; the ragged ones leave n % 8 != 0, off the
# kernels' 16-byte vectors
AUTO_SHAPES = [(16, 128, 4), (8, 128, 1), (5, 25, 3), (3, 7, 5)]


@pytest.mark.parametrize("rows,lanes,blocks", AUTO_SHAPES)
def test_auto_kernels_match_the_reference(ref, rows, lanes, blocks):
    shape = (blocks * rows, lanes)
    xj, xt = _bf16(shape, 0)
    yj, yt = _bf16(shape, 1)
    spec = pl.BlockSpec((rows, lanes), lambda i: (i, 0))
    seed_spec = pl.BlockSpec((1, 1), lambda i: (0, 0))
    call = functools.partial(pl.pallas_call, grid=(blocks,), interpret=True)
    copy_ref = call(ref._copy_kernel, in_specs=[spec], out_specs=spec,
                    out_shape=jax.ShapeDtypeStruct(shape, jnp.bfloat16))(xj)
    seed = np.float32(0.375)
    read_ref = call(ref._read_kernel, in_specs=[seed_spec, spec],
                    out_specs=seed_spec,
                    out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32))(
        jnp.full((1, 1), seed, jnp.float32), xj)
    triad_ref = call(ref._triad_kernel, in_specs=[spec, spec], out_specs=spec,
                     out_shape=jax.ShapeDtypeStruct(shape, jnp.bfloat16))(xj, yj)

    got = hbm_roof.copy(xt)
    assert torch.equal(got, _torch(copy_ref).to(torch.bfloat16))
    assert torch.equal(got, xt)
    seed_t = torch.full((1, 1), seed)
    got_read = hbm_roof.read_sum(seed_t, xt)
    assert got_read.shape == (1, 1) and got_read.dtype == torch.float32
    scale = xt.double().abs().sum().item()
    assert abs(got_read.item() - float(read_ref[0, 0])) <= READ_RTOL * scale
    assert abs(got_read.item() - (seed + xt.double().sum().item())) \
        <= READ_RTOL * scale
    got_triad = hbm_roof.triad(xt, yt)
    assert _ulps(got_triad, _torch(triad_ref).to(torch.bfloat16)) <= 1
    # the flat layout the probe streams takes the same values
    assert torch.equal(hbm_roof.triad(xt.reshape(-1), yt.reshape(-1)),
                       got_triad.reshape(-1))


# (chunks, slots): fewer chunks than slots, a count the slots do not
# divide, and an even one
@pytest.mark.parametrize("nchunks,nbuf", [(2, 4), (5, 2), (7, 4), (4, 4)])
def test_staged_copy_matches_the_manual_dma_kernel(ref, nchunks, nbuf):
    rows, lanes = 8, 128
    shape = (nchunks * rows, lanes)
    xj, xt = _bf16(shape, 2)
    slots = min(nbuf, nchunks)   # as bench_manual clips it

    def kernel(hbm_in, hbm_out, scratch, sems):
        ref._manual_copy_body(hbm_in, hbm_out, scratch, sems, nchunks=nchunks,
                              rows=rows, lanes=lanes, nbuf=slots)

    out = pl.pallas_call(
        kernel, in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((slots, rows, lanes), jnp.bfloat16),
                        pltpu.SemaphoreType.DMA((slots, 2))],
        interpret=pltpu.InterpretParams())(xj)
    got = hbm_roof.staged_copy(xt, rows * lanes * 2, nbuf)
    assert torch.equal(got, _torch(out).to(torch.bfloat16))
    # a ragged total: a short last chunk and a tail under 16 bytes
    tail = xt.reshape(-1)[:xt.numel() - 3].clone()
    assert torch.equal(hbm_roof.staged_copy(tail, 48, nbuf), tail)


@pytest.mark.parametrize("total_rows,nstreams", [(64, 8), (100, 4), (37, 1)])
def test_direct_copy_matches_the_hbm_dma_kernel(total_rows, nstreams):
    # bench_hbm_dma's kernel, with its shape rule: rows trimmed to a
    # multiple of 8 * nstreams
    rows, lanes = roofline_hbm.hbm_dma_shape(total_rows * 2048, nstreams)
    assert rows % (8 * nstreams) == 0 and lanes == 1024
    chunk = rows // nstreams
    xj, xt = _bf16((rows, lanes), 3)

    def kernel(hbm_in, hbm_out, sems):
        dmas = [pltpu.make_async_copy(hbm_in.at[pl.ds(s * chunk, chunk), :],
                                      hbm_out.at[pl.ds(s * chunk, chunk), :],
                                      sems.at[s]) for s in range(nstreams)]
        for d in dmas:
            d.start()
        for d in dmas:
            d.wait()

    out = pl.pallas_call(
        kernel, in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((rows, lanes), jnp.bfloat16),
        scratch_shapes=[pltpu.SemaphoreType.DMA((nstreams,))],
        interpret=pltpu.InterpretParams())(xj)
    got = hbm_roof.direct_copy(xt, nstreams)
    assert torch.equal(got, _torch(out).to(torch.bfloat16))


@pytest.fixture
def fixed_timers(ref, monkeypatch):
    """Both sides' ``_slope_timed`` replaced by one that runs a two-pass
    chain (the reference's kernels in interpret mode), keeps its output and
    returns FIXED_S."""
    outs = {"ref": [], "port": []}
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))

    def timer(side):
        def slope_timed(make_fn, feed, *args, **kw):
            outs[side].append(_torch(make_fn(2)(*args)) if side == "ref"
                              else make_fn(2)(*args).float().clone())
            return FIXED_S
        return slope_timed

    monkeypatch.setattr(ref, "_slope_timed", timer("ref"))
    monkeypatch.setattr(roofline_hbm, "_slope_timed", timer("port"))
    return outs


def _same_rates(a: dict, b: dict, keys) -> None:
    for k in keys:
        assert a[k] == b[k] and a[k] is not None, (k, a[k], b[k])


def _same_outputs(outs) -> None:
    assert len(outs["ref"]) == len(outs["port"])
    for r, p in zip(outs["ref"], outs["port"]):
        assert torch.equal(r.reshape(p.shape), p)


def test_bench_auto_counts_the_reference_bytes(ref, fixed_timers):
    rows, lanes, blocks = 8, 128, 3
    total = blocks * rows * lanes * 2
    want = ref.bench_auto(total, rows, lanes)
    got = roofline_hbm.bench_auto(total, 256, 4, "full", CPU)
    _same_rates(want, got, ("copy_gbps", "read_gbps", "triad_gbps"))
    assert got["device"] == "cpu" and (got["block"], got["grid"]) == (
        "256x4", "full")
    _same_outputs(fixed_timers)


def test_bench_manual_counts_the_reference_bytes(ref, fixed_timers):
    rows, lanes, nbuf = 8, 128, 2
    total = 5 * rows * lanes * 2
    want = ref.bench_manual(total, rows, lanes, nbuf)
    got = roofline_hbm.bench_manual(total, rows * lanes * 2, nbuf, CPU)
    _same_rates(want, got, ("copy_gbps",))
    assert got["nbuf"] == want["nbuf"]
    _same_outputs(fixed_timers)


@pytest.mark.parametrize("nstreams", [1, 8])
def test_bench_hbm_dma_counts_the_reference_bytes(ref, fixed_timers, nstreams):
    total = 101 * 2048 + 100   # 101 rows, trimmed as the reference trims
    want = ref.bench_hbm_dma(total, nstreams)
    got = roofline_hbm.bench_hbm_dma(total, nstreams, CPU)
    _same_rates(want, got, ("copy_gbps",))
    assert got["nstreams"] == nstreams
    _same_outputs(fixed_timers)


def test_bench_eager_counts_the_reference_bytes(ref, fixed_timers):
    total = 3 * 1024 * 2
    want = ref.bench_xla(total)
    got = roofline_hbm.bench_eager(total, CPU)
    _same_rates(want, got, ("copy_gbps", "read_gbps", "triad_gbps"))
    _same_outputs(fixed_timers)


def test_probe_main_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(roofline_hbm, "REPEATS", 1)
    res = roofline_hbm.main(["--device", "cpu", "--gib", str(2.0 ** -13)])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 3 + len(roofline_hbm.DMA_STREAMS) + len(
        roofline_hbm.AUTO_SWEEP) + len(roofline_hbm.MANUAL_SWEEP) + 1
    last = lines[-1]["roofline_hbm"]
    assert last == json.loads(json.dumps(res))
    assert last["device"] == "cpu" and last["roof_gbps"] > 0
    assert last["roof_from"].split(" ")[0] in ("auto", "manual", "hbm_dma")
    readings = (last["auto"] + last["manual"] + last["hbm_dma"]
                + [last["eager"], last["library"], last["calibration"]])
    assert all(r["device"] == "cpu" for r in readings)
    assert last["library_copy_gbps"] == last["library"]["copy_gbps"]


def test_probe_rejects_unknown_families():
    with pytest.raises(SystemExit):
        roofline_hbm.main(["--device", "cpu", "--skip", "xla"])


def test_roof_is_the_best_hand_written_copy_or_read():
    res = {"auto": [{"block": "a", "grid": "full", "copy_gbps": 10.0,
                     "read_gbps": 12.0},
                    {"block": "b", "grid": "persistent", "copy_gbps": 11.0,
                     "read_gbps": None}],
           "manual": [{"block": "16KiB", "nbuf": 2, "copy_gbps": 11.5}],
           "hbm_dma": [{"nstreams": 4, "copy_gbps": 9.0}],
           "library": {"copy_gbps": 99.0}}
    assert roofline_hbm.roof(res) == (12.0, "auto read, block a full grid")
    assert roofline_hbm.roof({}) == (None, None)


def test_clean_window_threshold_follows_the_data_sheet():
    # twice the time of an 8192^3 bf16 product at 989 TFLOP/s
    assert roofline_hbm.clean_matmul_ms() == pytest.approx(2.2235, rel=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(64, dtype=torch.bfloat16)
    seed = torch.zeros((1, 1))
    with pytest.raises(ValueError):
        hbm_roof.copy(x.float())
    with pytest.raises(ValueError):
        hbm_roof.copy(torch.zeros(8, 8, dtype=torch.bfloat16).t())
    with pytest.raises(ValueError):
        hbm_roof.copy(x[1:])                       # off 16 bytes
    with pytest.raises(ValueError):
        hbm_roof.copy(x, out=x)
    with pytest.raises(ValueError):
        hbm_roof.copy(x, threads=100)
    with pytest.raises(ValueError):
        hbm_roof.copy(x, vecs=8)
    with pytest.raises(ValueError):
        hbm_roof.read_sum(seed, x, grid="half")
    with pytest.raises(ValueError):
        hbm_roof.read_sum(seed.double(), x)
    with pytest.raises(ValueError):
        hbm_roof.read_sum(torch.zeros(2), x)
    with pytest.raises(ValueError):
        hbm_roof.triad(x, x[:32])
    with pytest.raises(ValueError):
        hbm_roof.staged_copy(x, 24, 2)             # chunk off 16 bytes
    with pytest.raises(ValueError):
        hbm_roof.staged_copy(x, 32, hbm_roof.MAX_NBUF + 1)
    with pytest.raises(ValueError):
        hbm_roof.direct_copy(torch.zeros(12, 1024, dtype=torch.bfloat16), 8)
    with pytest.raises(ValueError):
        hbm_roof.direct_copy(torch.zeros(4, 3, dtype=torch.bfloat16), 2)


def test_a_tensor_off_the_cpu_goes_to_the_kernel(monkeypatch):
    """Only a CPU tensor takes the plain version: any other goes to the
    kernel's library (here a stub that raises), never to a fallback."""
    class NoKernel(Exception):
        pass

    def load(name):
        raise NoKernel(name)

    monkeypatch.setattr(hbm_roof._build, "load", load)
    x = torch.empty(64, dtype=torch.bfloat16, device="meta")
    seed = torch.empty((1, 1), device="meta")
    for call in (lambda: hbm_roof.copy(x), lambda: hbm_roof.read_sum(seed, x),
                 lambda: hbm_roof.triad(x, x),
                 lambda: hbm_roof.staged_copy(x, 32, 2),
                 lambda: hbm_roof.direct_copy(x.reshape(8, 8), 2)):
        with pytest.raises(NoKernel):
            call()
