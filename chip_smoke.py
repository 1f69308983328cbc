#!/usr/bin/env python3
"""Drive bigdl_tpu_torch's serving and training paths on one CUDA card and
check them.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. environment: the card's name and power limit, the torch and CUDA
   versions, and the build of every CUDA kernel from ``bigdl_tpu_torch/csrc``
   (all ``nvcc`` processes at once);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serving and training paths' shapes, with the tolerances stated
   below; the flash backward (K2, K3) through the autograd ``Function``
   against ``flash_attention_bwd_plain`` fed the same o, lse and
   cotangents, and against autograd through the plain attention core;
3. slice: the 134M Llama-recipe LM (``scripts/int8_decode_bench.py``'s
   ``134m`` config: V=32000, E=768, 12 heads, 4 kv heads, FFN 3072, 12
   layers, RoPE, SwiGLU, RMSNorm, tied embeddings) built from a seed at full
   width; its bf16 (``cast_model``) and int8 (``quantize_model``) twins each
   serve 8 requests from threads through ``LMServer`` (prompts of 384 and
   128 tokens, 32 new tokens, greedy). Every answer must equal a direct
   ``generate`` on the same prompts, and the launch counters, zeroed just
   before serving, must show that the prefill ran kernel K1 and the int8
   decode kernel K4;
3b. training: the same config built on the card from seed 7. Every
   parameter's gradient on one f32 batch (B=1, S=128) of the synthetic
   grammar, through K1/K2/K3, must be finite and within GRAD_RTOL (relative
   L2, per tensor) of a CPU copy carrying the same weights, which takes the
   plain path. Then ``Optimizer`` trains 20 iterations at B=8, S=512 with
   ``set_precision("bf16")``, ``AdamW`` and global-L2 clipping at 1.0: the
   losses must be finite, the mean of the last five below the first, and
   K1, K2 and K3 each launched exactly 12 x 20 times (counters zeroed just
   before the run);
4. timing: each kernel is checked once more against its plain version at
   the served shape, then it (``ms``), its plain version (``plain_ms``) and
   one PyTorch library call for the same function (``library_ms``) are
   timed as device time by ``torch.profiler``, or by CUDA events where the
   profiler records nothing (K2 and K3 at the training shape, B=8 S=512
   N=12 D=64 bf16 causal); the bound (``bound_ms``) is
   the larger of the bytes the function must move over 3.35 TB/s and its
   operations over 989 TFLOP/s (H100 SXM data sheet, bf16 dense).

The last three lines of standard output are the card's name and power
limit, the ``{"kernels": [...]}`` line, and ``{"ok": true, "device": ...}``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_OPS_PER_S = 989e12     # H100 SXM tensor cores, bf16 dense
CONFIG = dict(embed_dim=768, num_heads=12, num_kv_heads=4, ffn_dim=3072,
              num_layers=12, max_len=512, rope=True, activation="swiglu",
              norm="rms", bias=False, tie_embeddings=True)
VOCAB = 32000
NEW_TOKENS = 32
PROMPT_LENS = (384, 128)
REQUESTS_PER_LEN = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20
TRAIN_LR, TRAIN_DECAY, TRAIN_CLIP = 3e-3, 0.01, 1.0


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


PROFILER_TRIES = 3


def profiled(fn, what: str):
    """Runs ``fn`` once under ``torch.profiler`` (CUDA activity) and returns
    ([(kernel name, device us)], wall seconds of the run). An H100 run has
    seen the profiler, after many sessions in one process, come back with
    no device time for work that launched kernels; such a run is logged and
    repeated, at most PROFILER_TRIES times. Returns (None, None) when no
    run recorded device time."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILER_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total)
                for e in prof.key_averages() if e.self_device_time_total > 0]
        if rows:
            return rows, wall
        log({"profiler_recorded_nothing": what, "attempt": attempt})
    return None, None


def device_ms(fn, iters: int, what: str, warmup: int = 3):
    """Device milliseconds per run of ``fn``: the kernel time that
    ``torch.profiler`` records over ``iters`` runs (host gaps between
    launches excluded), and the three kernels that took the most of it.
    When the profiler records nothing (see ``profiled``), the time between
    two CUDA events around the same ``iters`` runs instead, which counts
    the gaps between launches too; that is logged as ``timed_with_events``
    and the kernel list then names the timer."""
    for _ in range(warmup):
        fn()

    def runs():
        for _ in range(iters):
            fn()

    rows, _ = profiled(runs, what)
    if rows is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        runs()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        check(ms > 0, f"{what}: neither the profiler nor CUDA events "
                      "measured any time")
        log({"timed_with_events": what, "ms": ms})
        return ms, [("cuda events (profiler recorded nothing)", ms * 1e3)]
    total_us = sum(t for _, t in rows)
    top = sorted(rows, key=lambda r: -r[1])[:3]
    return total_us / iters / 1e3, [(k[:60], t / iters) for k, t in top]


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------ 1. environment
def environment():
    from bigdl_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0),
         "capability": list(torch.cuda.get_device_capability(0))})
    build_s = _build.build()
    log({"kernel_build_s": build_s, "kernels": list(_build.KERNELS)})
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    return card


# ---------------------------------------------------------------- 2. kernels
def _qkv(gen, b, sq, sk, n, d, dtype):
    mk = lambda s: torch.randn((b, s, n, d), generator=gen, device="cuda")
    return mk(sq).to(dtype), mk(sk).to(dtype), mk(sk).to(dtype)


FLASH_ATOL = 5e-5
INT8_RTOL = 1e-4


def flash_o_close(o: torch.Tensor, po: torch.Tensor):
    """K1's O against the plain version's, element by element: within
    FLASH_ATOL in float32 (f32 sums in another order, values of order 1-10);
    in bfloat16 within one bf16 step of the element, 2^-7 * |po|, plus
    FLASH_ATOL (both round nearly the same f32 value, which may sit on a
    rounding boundary). Returns (max |o - po|, whether every element holds)."""
    diff = (o.float() - po.float()).abs()
    tol = (2 ** -7 * po.float().abs() if o.dtype == torch.bfloat16
           else torch.zeros_like(diff)) + FLASH_ATOL
    return diff.max().item(), bool((diff <= tol).all().item())


def check_flash():
    """K1 against ``flash_attention_plain`` (O as in ``flash_o_close``, LSE
    within FLASH_ATOL), at the served prefill shapes (B=4, S in {384, 128},
    causal) and at ragged, full, D=128, Sq != Sk and single-row cases."""
    from bigdl_tpu_torch.ops.flash_attention import (NEG, flash_attention_plain,
                                                     flash_attention_with_lse)
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(dt, causal, 2, s, s, 12, 64)
             for dt in dtypes for causal in (True, False) for s in (384, 333)]
    cases += [(dt, True, REQUESTS_PER_LEN, s, s, 12, 64)
              for dt in dtypes for s in PROMPT_LENS]
    cases += [(torch.bfloat16, True, 1, 200, 200, 4, 128),
              (torch.float32, False, 2, 100, 333, 3, 128),
              (torch.float32, True, 4, 1, 1, 12, 64)]
    worst = 0.0
    for dt, causal, b, sq, sk, n, d in cases:
        q, k, v = _qkv(gen, b, sq, sk, n, d, dt)
        o, lse = flash_attention_with_lse(q, k, v, causal=causal)
        po, plse = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_o, ok_o = flash_o_close(o, po)
        err_l = (lse - plse).abs().max().item()
        check(o.shape == q.shape and lse.shape == (b, n, sq)
              and o.dtype == dt, f"flash output shapes, B={b} Sq={sq}")
        check(ok_o and err_l <= FLASH_ATOL,
              f"flash {dt} causal={causal} B={b} Sq={sq} Sk={sk} N={n} D={d}:"
              f" |dO|={err_o} |dLSE|={err_l}")
        worst = max(worst, err_o)
    for dt in (torch.float32, torch.bfloat16):
        # dead row: every logit of (b=0, s=5, h=0) overflows to -inf
        q, k, v = _qkv(gen, 1, 70, 70, 2, 64, dt)
        q[0, 5, 0] = 0
        q[0, 5, 0, 0] = -3e38
        k[:, :, 0, 0] = 100
        o, lse = flash_attention_with_lse(q, k, v, causal=True)
        po, plse = flash_attention_plain(q, k, v, causal=True)
        check(lse[0, 0, 5].item() == NEG and plse[0, 0, 5].item() == NEG,
              f"dead-row LSE sentinel ({dt})")
        check(o[0, 5, 0].abs().max().item() == 0.0, f"dead-row O ({dt})")
        check(torch.isfinite(o.float()).all().item()
              and torch.isfinite(lse).all().item(), f"dead-row finite ({dt})")
    log({"check": "flash_fwd", "cases": len(cases) + 2, "max_abs_err_o": worst})


BWD_F32_RTOL, BWD_F32_ATOL = 1e-4, 1e-5
BWD_BF16_ATOL = 1e-5


def bwd_close(got: torch.Tensor, ref: torch.Tensor):
    """A backward kernel's output against the plain version's, element by
    element. float32: within BWD_F32_RTOL * max|ref| + BWD_F32_ATOL (f32
    sums of up to Sk or Sq products in another order). bfloat16: within one
    bf16 step of the element, 2^-7 * |ref|, plus BWD_BF16_ATOL: both round
    an f32 sum to bf16, and where that sum is near zero its f32 ordering
    error is large against the element's own step (on an H100 the largest
    excess over one step measured 4.6e-8, so the atol keeps a margin of
    200). Returns (max |got - ref|, the largest excess over the one-step
    part in bf16, or the error over max|ref| in f32, whether all hold)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    if got.dtype == torch.bfloat16:
        step = 2 ** -7 * r.abs()
        ok = diff <= step + BWD_BF16_ATOL
        excess = (diff - step).clamp_min(0).max().item()
    else:
        ok = diff <= BWD_F32_RTOL * r.abs().max() + BWD_F32_ATOL
        excess = (diff.max() / r.abs().max().clamp_min(1e-30)).item()
    return (diff.max().item(), excess,
            bool(ok.all().item() and torch.isfinite(g).all().item()))


def _function_grads(q, k, v, g_o, g_lse, causal):
    """(o, lse, dq, dk, dv) through ``FlashAttention``: K1, then K2 + K3."""
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_with_lse
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    if g_lse is None:
        o.backward(g_o)
    else:
        torch.autograd.backward((o, lse), (g_o, g_lse))
    return o.detach(), lse.detach(), q.grad, k.grad, v.grad


def check_flash_bwd():
    """K2 and K3 through the autograd Function against
    ``flash_attention_bwd_plain`` fed the same o, lse and cotangents (see
    ``bwd_close``): at the training shape in bf16 (B=8 S=512 N=12 D=64,
    causal, with and without an LSE cotangent), f32 causal and full at
    S in {384, 333}, D=128, Sq != Sk, one row, and the dead row of
    ``check_flash``. Then the Function against autograd through the plain
    attention core at the training shape in f32. Returns the worst
    |error| of dQ (K2) and of dK/dV (K3) at the training shape."""
    from bigdl_tpu_torch.ops.attention_core import dot_product_attention
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_bwd_plain
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    n_train = CONFIG["num_heads"]
    cases = [(bf16, True, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, n_train, 64, g)
             for g in (False, True)]
    cases += [(f32, causal, 2, s, s, n_train, 64, True)
              for causal in (True, False) for s in (384, 333)]
    cases += [(bf16, False, 2, 333, 333, n_train, 64, True),
              (bf16, True, 1, 200, 200, 4, 128, True),
              (f32, True, 2, 333, 333, 3, 128, False),
              (f32, False, 2, 100, 333, 3, 64, True),
              (bf16, False, 2, 333, 100, 3, 128, True),
              (f32, True, 4, 1, 1, n_train, 64, True)]
    worst = {"dq": 0.0, "dkv": 0.0}
    excess = {f32: 0.0, bf16: 0.0}
    for dt, causal, b, sq, sk, n, d, with_g_lse in cases:
        q, k, v = _qkv(gen, b, sq, sk, n, d, dt)
        g_o = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        g_lse = (torch.randn((b, n, sq), generator=gen, device="cuda")
                 if with_g_lse else None)
        o, lse, *grads = _function_grads(q, k, v, g_o, g_lse, causal)
        plain = flash_attention_bwd_plain(q, k, v, o, lse, g_o, g_lse,
                                          causal, 1.0 / d ** 0.5)
        torch.cuda.synchronize()
        for name, got, ref in zip(("dq", "dk", "dv"), grads, plain):
            err, ex, ok = bwd_close(got, ref)
            check(ok and got.shape == ref.shape and got.dtype == dt,
                  f"flash bwd {name} {dt} causal={causal} B={b} Sq={sq} "
                  f"Sk={sk} N={n} D={d} g_lse={with_g_lse}: |err| {err} "
                  f"(bf16: excess over one step; f32: over max|ref|: {ex})")
            excess[dt] = max(excess[dt], ex)
            if (b, sq) == (TRAIN_BATCH, TRAIN_SEQ):
                key = "dq" if name == "dq" else "dkv"
                worst[key] = max(worst[key], err)
    for dt in (f32, bf16):
        # the dead row of check_flash: (b=0, s=5, h=0) sees only -inf logits
        q, k, v = _qkv(gen, 1, 70, 70, 2, 64, dt)
        q[0, 5, 0] = 0
        q[0, 5, 0, 0] = -3e38
        k[:, :, 0, 0] = 100
        g_o = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        g_lse = torch.randn((1, 2, 70), generator=gen, device="cuda")
        o, lse, *grads = _function_grads(q, k, v, g_o, g_lse, True)
        plain = flash_attention_bwd_plain(q, k, v, o, lse, g_o, g_lse, True,
                                          1.0 / 8)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, plain):
            err, _, ok = bwd_close(got, ref)
            check(ok and torch.isfinite(ref.float()).all().item(),
                  f"dead-row {name} ({dt}): |err| {err}")
        check(grads[0][0, 5, 0].abs().max().item() == 0.0,
              f"dead-row dQ is not 0 ({dt})")
    # the Function against autograd through the plain core, f32, training shape
    q, k, v = _qkv(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, n_train, 64, f32)
    g_o = torch.randn(q.shape, generator=gen, device="cuda")
    _, _, *grads = _function_grads(q, k, v, g_o, None, True)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    dot_product_attention(*ts, causal=True).backward(g_o)
    autograd_err = 0.0
    for name, got, t in zip(("dq", "dk", "dv"), grads, ts):
        err, _, ok = bwd_close(got, t.grad)
        check(ok, f"Function vs autograd of the plain core, {name}: {err}")
        autograd_err = max(autograd_err, err)
    log({"check": "flash_bwd", "cases": len(cases) + 3,
         "max_abs_err_dq_train_shape": worst["dq"],
         "max_abs_err_dkv_train_shape": worst["dkv"],
         "bf16_max_excess_over_one_step": excess[bf16],
         "f32_max_err_over_max_ref": excess[f32],
         "function_vs_plain_core_autograd_f32": autograd_err})
    return worst


def check_int8():
    """K4 against ``int8_matmul_plain`` through the public ``int8_matmul``
    (compute dtype f32, with and without a bias), M in {1, 4 (the served
    decode batch), 8}. Tolerance: INT8_RTOL of max|y|: the same exact
    int8 x bf16 products summed in f32 in another order (K <= 3072)."""
    from bigdl_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(768, 768), (256, 768), (3072, 768), (768, 3072), (32000, 768),
              (1100, 768)]
    cases = [(m, o, kd) for m in (1, REQUESTS_PER_LEN, 8) for o, kd in shapes]
    cases += [(9, 768, 768), (256, 1100, 768), (256, 768, 3072)]
    worst = 0.0
    for m, o, kd in cases:
        w = torch.randint(-127, 128, (o, kd), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((o, 1), generator=gen, device="cuda") * 1e-2 + 1e-3
        x = torch.randn((m, kd), generator=gen, device="cuda")
        bias = torch.randn((o,), generator=gen, device="cuda")
        for xdt in (torch.float32, torch.bfloat16):
            for b in (None, bias):
                y = int8_matmul(x.to(xdt), w, s, b, torch.float32)
                ref = int8_matmul_plain(x.to(xdt), w, s.reshape(o))
                if b is not None:
                    ref = ref + b
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                tol = INT8_RTOL * ref.abs().max().item()
                check(y.shape == (m, o) and err <= tol,
                      f"int8 M={m} O={o} K={kd} x={xdt} bias={b is not None}:"
                      f" err {err} > {tol}")
                worst = max(worst, err / max(ref.abs().max().item(), 1e-30))
    log({"check": "int8_matmul", "cases": 4 * len(cases),
         "max_rel_err": worst})


# ------------------------------------------------------------------ 3. slice
def serve(model, prompts):
    """All prompts from threads through one LMServer; returns the answers,
    the batches served and the wall seconds."""
    from bigdl_tpu_torch.models.lm_server import LMServer
    server = LMServer(model, max_batch=REQUESTS_PER_LEN, batch_timeout_ms=2000,
                      max_new_tokens=NEW_TOKENS, greedy=True, device="cuda")
    results = [None] * len(prompts)
    errors = []
    barrier = threading.Barrier(len(prompts))

    def client(i):
        try:
            barrier.wait(timeout=60)
            results[i] = server.submit(prompts[i], timeout=600)
        except Exception as e:  # collected and raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        seconds = time.perf_counter() - t0
    finally:
        server.close()
    check(not any(t.is_alive() for t in threads), "a client never returned")
    if errors:
        raise errors[0]
    return results, server.batches_served, seconds


def time_generate(model, prompts) -> dict:
    """Prefill and decode times of one batch (host clock around work that
    ends in a synchronize), and the share of the decode run in which the
    device was busy (profiler kernel time over wall time)."""
    from bigdl_tpu_torch.models.generation import generate
    batch = torch.as_tensor(prompts, device="cuda")

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, batch, n, greedy=True, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(NEW_TOKENS)  # warm-up
    t1 = min(run(1) for _ in range(3))
    tn = min(run(NEW_TOKENS) for _ in range(3))
    b, s = batch.shape
    rows, _ = profiled(lambda: generate(model, batch, NEW_TOKENS, greedy=True,
                                        device="cuda"), f"decode B={b} S={s}")
    # None ("not measured") when the profiler recorded nothing
    busy = (None if rows is None
            else sum(t for _, t in rows) / 1e6 / tn)
    top = ([] if rows is None else
           [(k[:60], t) for k, t in sorted(rows, key=lambda r: -r[1])[:3]])
    return {"batch": b, "prompt_len": s, "new_tokens": NEW_TOKENS,
            "prefill_ms": t1 * 1e3,
            "decode_ms_per_token": (tn - t1) / (NEW_TOKENS - 1) * 1e3,
            "tokens_per_s": b * NEW_TOKENS / tn,
            "device_busy_share": busy, "top_kernels_us": top}


def run_slice():
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    from bigdl_tpu_torch.ops import flash_attention, int8_matmul

    t0 = time.perf_counter()
    base = build_lm(VOCAB, **CONFIG, device="cuda", seed=7).evaluate_mode()
    twins = {"bf16": cast_model(base, torch.bfloat16, device="cuda"),
             "int8": quantize_model(base, torch.bfloat16, device="cuda")}
    n_params = sum(p.numel() for p in base.parameters())
    log({"model": "134m", "params": n_params,
         "build_s": time.perf_counter() - t0})
    rng = np.random.default_rng(0)
    groups = {s: [rng.integers(1, VOCAB + 1, s).tolist()
                  for _ in range(REQUESTS_PER_LEN)] for s in PROMPT_LENS}
    prompts = [p for s in PROMPT_LENS for p in groups[s]]

    counters = (flash_attention.LAUNCHES, int8_matmul.LAUNCHES,
                int8_matmul.DEQUANT_CALLS)
    launches = {"flash_fwd": 0, "int8_matmul": 0}
    answers = {}
    for name, model in twins.items():
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        results, batches, seconds = serve(model, prompts)
        k1, k4, deq = (c.value for c in counters)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        launches["flash_fwd"] += k1
        launches["int8_matmul"] += k4
        answers[name] = results
        layers = CONFIG["num_layers"]
        per_token = 7 * layers + 1  # q, k, v, out, up, gate, down; the head
        # each batch: a prefill of M = 4 * prompt_len > 256 rows takes the
        # dequantize path except the head, which reads the last position
        # only (M = 4), then NEW_TOKENS - 1 single-token steps
        k4_want = (1 + per_token * (NEW_TOKENS - 1)) * batches
        log({"twin": name, "served": len(results), "batches": batches,
             "serve_s": seconds, "k1_launches": k1, "k4_launches": k4,
             "dequant_calls": deq, "peak_allocated_mib": peak_mb})
        check(batches == len(PROMPT_LENS), f"{name}: {batches} batches")
        check(k1 == layers * batches and k1 > 0,
              f"{name}: prefill launched K1 {k1} times")
        if name == "int8":
            check(k4 == k4_want and k4 > 0 and deq == (per_token - 1) * batches,
                  f"int8 twin launched K4 {k4} times (want {k4_want}), "
                  f"dequantized {deq} times")
        else:
            check(k4 == 0 and deq == 0, "bf16 twin touched the int8 path")

    for name, model in twins.items():
        for s in PROMPT_LENS:
            direct = generate(model, groups[s], NEW_TOKENS, greedy=True,
                              device="cuda")[:, s:].cpu().tolist()
            for p, want in zip(groups[s], direct):
                got = answers[name][prompts.index(p)]
                check(got == want, f"{name}: LMServer answer != generate "
                                   f"(prompt length {s})")
                check(len(got) == NEW_TOKENS
                      and all(1 <= t <= VOCAB for t in got),
                      f"{name}: malformed continuation")
        log({"twin": name, "answers_equal_generate": True})

    # the twins against the f32 model on a small input: finite log-probs of
    # the expected shape whose top-1 token agrees at (nearly) every position
    ids = torch.as_tensor(rng.integers(1, VOCAB + 1, (1, 64)), device="cuda")
    with torch.inference_mode():
        ref = base(ids)
        for name, model in twins.items():
            lp = model(ids).float()
            agree = (lp.argmax(-1) == ref.argmax(-1)).float().mean().item()
            check(lp.shape == (1, 64, VOCAB) and torch.isfinite(lp).all().item(),
                  f"{name}: log-probs")
            log({"twin": name, "top1_agreement_vs_f32": agree})
            check(agree >= 0.9, f"{name}: top-1 agreement {agree}")

    for name, model in twins.items():
        for s in PROMPT_LENS:
            log({"twin": name, **time_generate(model, groups[s])})
    return twins["int8"], launches


# -------------------------------------------------------------- 3b. training
GRAD_RTOL = 1e-3


def grad_check(model) -> None:
    """Every parameter's gradient of one f32 batch (B=1, S=128) on the card
    (K1, K2, K3) against a CPU copy with the same weights (the plain path):
    finite, and within GRAD_RTOL in relative L2 per tensor (f32 sums in
    other orders; the two paths agree to ~1e-6)."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                    import_lm_state_dict)
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.ops import flash_attention as fa
    cpu = build_lm(VOCAB, **CONFIG, device="cpu", seed=0)
    import_lm_state_dict(cpu, export_lm_state_dict(model))
    sample = synthetic_corpus(1, 128, VOCAB, seed=1)[0]
    grads = []   # the card's, then the CPU's
    for m in (model, cpu):
        dev = next(m.parameters()).device
        m.train()
        m.zero_grad(set_to_none=True)
        for c in (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV):
            c.reset()
        ids = torch.as_tensor(sample.feature[None], device=dev)
        tgt = torch.as_tensor(sample.label[None], device=dev)
        FusedLMHeadCriterion()(m(ids), tgt).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
        if dev.type == "cuda":
            layers = CONFIG["num_layers"]
            check((fa.LAUNCHES.value, fa.LAUNCHES_DQ.value,
                   fa.LAUNCHES_DKV.value) == (layers,) * 3,
                  "the card's gradient did not run K1, K2 and K3 once a layer")
    model.zero_grad(set_to_none=True)
    worst, worst_name = 0.0, ""
    for name, ref in grads[1].items():
        got = grads[0][name]
        check(got is not None and torch.isfinite(got).all().item(),
              f"gradient of {name} on the card is missing or not finite")
        rel = ((got.cpu() - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        check(rel <= GRAD_RTOL, f"gradient of {name}: relative L2 {rel}")
        if rel > worst:
            worst, worst_name = rel, name
    log({"check": "grad_134m_f32_B1_S128", "params": len(grads[1]),
         "max_rel_l2": worst, "worst_param": worst_name})


def _train(model, ds, steps: int):
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.optim import AdamW, Optimizer, Trigger
    opt = (Optimizer(model, ds, FusedLMHeadCriterion(), device="cuda")
           .set_precision("bf16")
           .set_optim_method(AdamW(learningrate=TRAIN_LR,
                                   weightdecay=TRAIN_DECAY))
           .set_gradient_clipping_by_l2_norm(TRAIN_CLIP)
           .set_end_when(Trigger.max_iteration(steps)))
    opt.optimize()
    torch.cuda.synchronize()
    return opt.history


def lm_head_ce_peak_mib() -> float:
    """Peak device memory of the fused LM-head CE's forward and backward at
    the training shape (N = 8 x 512 rows, V=32000, E=768, bf16, the
    default chunk 16384), above what its inputs hold."""
    from bigdl_tpu_torch.ops.lm_head_ce import fused_lm_head_ce
    gen = torch.Generator(device="cuda").manual_seed(8)
    n, e = TRAIN_BATCH * TRAIN_SEQ, CONFIG["embed_dim"]
    h = torch.randn((n, e), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((VOCAB, e), generator=gen, device="cuda").to(torch.bfloat16)
    tgt = torch.randint(1, VOCAB + 1, (n,), generator=gen, device="cuda")
    h.requires_grad_()
    w.requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_lm_head_ce(h, w, None, tgt).backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def run_training() -> dict:
    """Phase 3b; returns the K1, K2, K3 launches of the 20-step run."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    model = build_lm(VOCAB, **CONFIG, device="cuda", seed=7)
    grad_check(model)
    log({"grad_check_s": time.perf_counter() - t0})
    samples = synthetic_corpus(TRAIN_BATCH * TRAIN_STEPS, TRAIN_SEQ, VOCAB,
                               seed=17)
    ds = DataSet.array(samples, seed=0) >> SampleToBatch(TRAIN_BATCH)
    counters = (fa.LAUNCHES, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t1 = time.perf_counter()
    history = _train(model, ds, TRAIN_STEPS)
    train_s = time.perf_counter() - t1
    k1, k2, k3 = (c.value for c in counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [h["loss"] for h in history]
    step_s = float(np.median([h["seconds"] for h in history[3:]]))
    want = CONFIG["num_layers"] * TRAIN_STEPS
    log({"train": "134m", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
         "precision": "bf16", "optim": f"AdamW lr={TRAIN_LR} "
         f"decay={TRAIN_DECAY}", "clip_l2": TRAIN_CLIP, "losses": losses})
    log({"train_steps": len(losses), "train_s": train_s,
         "step_ms_median": step_s * 1e3,
         "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
         "peak_allocated_mib": peak_mib, "k1_launches": k1,
         "k2_launches": k2, "k3_launches": k3})
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"loss did not fall: first {losses[0]}, last five {losses[-5:]}")
    check(k1 == k2 == k3 == want,
          f"training launched K1/K2/K3 {k1}/{k2}/{k3} times, want {want}")

    # device busy share: kernel time over the wall time of 4 more steps;
    # None ("not measured") when the profiler recorded nothing
    extra = DataSet.array(samples[:4 * TRAIN_BATCH], seed=1) \
        >> SampleToBatch(TRAIN_BATCH)
    rows, wall = profiled(lambda: _train(model, extra, 4), "training steps")
    busy = None if rows is None else sum(t for _, t in rows) / 1e6 / wall
    top = ([] if rows is None else
           sorted(((k[:60], t / 4) for k, t in rows), key=lambda r: -r[1])[:6])
    log({"train_device_busy_share": busy, "profiled_steps": 4,
         "profiled_wall_s": wall, "top_kernels_us_per_step": top,
         "lm_head_ce_peak_mib": lm_head_ce_peak_mib()})
    del model
    torch.cuda.empty_cache()
    return {"flash_fwd": k1, "flash_bwd_dq": k2, "flash_bwd_dkv": k3}


# ----------------------------------------------------------------- 4. timing
def time_flash(launches: int) -> dict:
    from bigdl_tpu_torch.ops.flash_attention import (flash_attention_plain,
                                                     flash_attention_with_lse)
    b, s, n, d = REQUESTS_PER_LEN, PROMPT_LENS[0], CONFIG["num_heads"], 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = _qkv(gen, b, s, s, n, d, torch.bfloat16)
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    po, plse = flash_attention_plain(q, k, v, causal=True)
    err, ok = flash_o_close(o, po)
    err_l = (lse - plse).abs().max().item()
    check(ok and err_l <= FLASH_ATOL,
          f"flash at the served shape: |dO|={err} |dLSE|={err_l}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms, _ = device_ms(lambda: flash_attention_with_lse(q, k, v, causal=True),
                      50, "flash_fwd")
    plain_ms, _ = device_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                            20, "flash_fwd plain")
    library_ms, _ = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 50,
                              "flash_fwd library")
    nbytes = 4 * b * s * n * d * 2 + b * n * s * 4   # q, k, v, o; lse f32
    ops = 4 * b * n * d * (s * (s + 1) // 2)         # causal (q, k) pairs
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "bigdl_tpu/ops/flash_attention.py:104",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "work": f"one causal prefill launch, bf16 B={b} S={s} N={n} "
                    f"D={d}; launches: serving and training runs together"}


def time_flash_bwd(launches: dict) -> list:
    """K2 and K3 at the training shape (bf16, causal): one launch each,
    its plain version, and the backward of ``scaled_dot_product_attention``
    (one call for dQ, dK and dV, so the same number on both rows)."""
    from bigdl_tpu_torch.ops.flash_attention import (
        bwd_delta, flash_attention_with_lse, flash_bwd_dkv,
        flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)
    b, s, n, d = TRAIN_BATCH, TRAIN_SEQ, CONFIG["num_heads"], 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = _qkv(gen, b, s, s, n, d, torch.bfloat16)
    g_o = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        o, lse = flash_attention_with_lse(q, k, v, causal=True)
    args = (q, k, v, g_o, lse, bwd_delta(o, g_o, None), True, 1.0 / d ** 0.5)
    dq, (dk, dv) = flash_bwd_dq(*args), flash_bwd_dkv(*args)
    pdq, (pdk, pdv) = flash_bwd_dq_plain(*args), flash_bwd_dkv_plain(*args)
    errs = {}
    for name, got, ref in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        errs[name], _, ok = bwd_close(got, ref)
        check(ok, f"flash bwd {name} at the timed shape: |err| {errs[name]}")
    ms_dq, _ = device_ms(lambda: flash_bwd_dq(*args), 20, "flash_bwd_dq")
    ms_dkv, _ = device_ms(lambda: flash_bwd_dkv(*args), 20, "flash_bwd_dkv")
    plain_dq, _ = device_ms(lambda: flash_bwd_dq_plain(*args), 5,
                            "flash_bwd_dq plain")
    plain_dkv, _ = device_ms(lambda: flash_bwd_dkv_plain(*args), 5,
                             "flash_bwd_dkv plain")
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    g_t = g_o.transpose(1, 2)
    library_ms, _ = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), g_t, retain_graph=True), 20, "flash_bwd library")
    bsnd, bns = b * s * n * d, b * n * s
    pairs = b * n * s * (s + 1) // 2                 # causal (q, k) pairs
    reads = 4 * bsnd * 2 + 2 * bns * 4               # q, k, v, dO; lse, delta
    dq_bound = bound(reads + bsnd * 2, 3 * 2 * d * pairs)
    dkv_bound = bound(reads + 2 * bsnd * 2, 4 * 2 * d * pairs)
    work = f"one causal backward launch, bf16 B={b} S={s} N={n} D={d}"
    lib_note = ("library_ms: the backward of scaled_dot_product_attention, "
                "one call for dQ, dK and dV")
    return [{"name": "flash_bwd_dq", "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "bigdl_tpu/ops/flash_attention.py:146",
             "launches": launches["flash_bwd_dq"], "max_abs_err": errs["dq"],
             "ms": ms_dq, "plain_ms": plain_dq, "bound_ms": dq_bound[0],
             "bound_by": dq_bound[1], "library_ms": library_ms,
             "work": f"{work}; {lib_note}"},
            {"name": "flash_bwd_dkv", "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "bigdl_tpu/ops/flash_attention.py:186",
             "launches": launches["flash_bwd_dkv"],
             "max_abs_err": max(errs["dk"], errs["dv"]),
             "ms": ms_dkv, "plain_ms": plain_dkv, "bound_ms": dkv_bound[0],
             "bound_by": dkv_bound[1], "library_ms": library_ms,
             "work": f"{work}; {lib_note}"}]


def time_int8(twin, launches: int) -> dict:
    from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_kernel,
                                                 int8_matmul_plain)
    m = REQUESTS_PER_LEN
    enc = twin[1]
    e, ekv = CONFIG["embed_dim"], twin[1].layer0.self_attn._e_kv
    weights = []
    for i in range(enc.num_layers):
        layer = enc._modules[f"layer{i}"]
        a = layer.self_attn
        wq, sq = a.in_proj_weight_q, a.in_proj_weight_scale
        weights += [(wq[:e], sq[:e]), (wq[e:e + ekv], sq[e:e + ekv]),
                    (wq[e + ekv:], sq[e + ekv:]),
                    (a.out_proj_weight_q, a.out_proj_weight_scale)]
        weights += [(lin.weight_q, lin.weight_scale) for lin in
                    (layer.linear1, layer.linear_gate, layer.linear2)]
    weights.append((twin[0].weight_q, twin[0].weight_scale))
    gen = torch.Generator(device="cuda").manual_seed(4)
    calls = [(torch.randn((m, w.shape[1]), generator=gen, device="cuda")
              .to(torch.bfloat16), w, s.reshape(-1).contiguous())
             for w, s in weights]
    deq = [(w.float() * s[:, None]).to(torch.bfloat16) for _, w, s in calls]
    err = 0.0
    for x, w, s in calls:
        y, ref = int8_matmul_kernel(x, w, s), int8_matmul_plain(x, w, s)
        e, tol = (y - ref).abs().max().item(), INT8_RTOL * ref.abs().max().item()
        check(e <= tol, f"int8 at the served shape M={x.shape[0]} "
                        f"O={w.shape[0]} K={w.shape[1]}: err {e} > {tol}")
        err = max(err, e)

    def kernel():
        for x, w, s in calls:
            int8_matmul_kernel(x, w, s)

    def plain():
        for x, w, s in calls:
            int8_matmul_plain(x, w, s)

    def library():
        for (x, _, _), wd in zip(calls, deq):
            x @ wd.T

    ms, _ = device_ms(kernel, 20, "int8_matmul")
    plain_ms, _ = device_ms(plain, 10, "int8_matmul plain")
    library_ms, _ = device_ms(library, 20, "int8_matmul library")
    nbytes = sum(x.numel() * 2 + w.numel() + s.numel() * 4
                 + x.shape[0] * w.shape[0] * 4 for x, w, s in calls)
    ops = sum(2 * x.shape[0] * w.numel() for x, w, _ in calls)
    bound_ms, bound_by = bound(nbytes, ops)
    shapes = {}
    for (x, w, s), wd in zip(calls, deq):
        key = f"{w.shape[0]}x{w.shape[1]}"
        if key not in shapes:
            one, _ = device_ms(lambda: int8_matmul_kernel(x, w, s), 50,
                               f"int8_matmul {key}")
            lib_one, _ = device_ms(lambda: x @ wd.T, 50,
                                   f"int8_matmul {key} library")
            shapes[key] = {"ms": one, "library_ms": lib_one, "bound_ms": bound(
                w.numel() + x.numel() * 2 + s.numel() * 4
                + x.shape[0] * w.shape[0] * 4, 2 * x.shape[0] * w.numel())[0]}
    log({"int8_shapes_M4": shapes})
    return {"name": "int8_matmul", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "bigdl_tpu/ops/int8_matmul.py:92",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "work": f"one int8 decode token: {len(calls)} launches at M={m}, "
                    f"{sum(w.numel() for _, w, _ in calls)} weight bytes"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = environment()
    check_flash()
    check_flash_bwd()
    check_int8()
    int8_twin, launches = run_slice()
    train_launches = run_training()
    kernels = [time_flash(launches["flash_fwd"] + train_launches["flash_fwd"]),
               *time_flash_bwd(train_launches),
               time_int8(int8_twin, launches["int8_matmul"])]
    log({"total_s": time.perf_counter() - t0})
    print(card, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
