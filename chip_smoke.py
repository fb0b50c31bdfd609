"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root, one GPU

Phases, each printing one JSON line; any failure raises (nonzero exit,
no result line):

1. device   - the card's name and power limit, TF32 off;
2. build    - the CUDA kernels of ``src/repro_torch/csrc`` compiled by
              nvcc, with the build time;
3. kernels  - each kernel against its plain PyTorch version on the card
              at the serving paths' shapes, max errors beside their
              tolerances; split-KV paged attention bitwise invariant
              under the page layout and under the batch (a row alone
              equals its row of B = 8), and on a bf16 pool of 16-token
              pages with a window starting mid-split, and at the pooled
              path's shape (bf16 q, fp32 pool of 16-token pages, H=KV=16,
              D=64, 8-page tables; rows alone and in pairs bitwise equal
              to their rows of B = 4); flash on its
              tensor-core kernel (bf16 q) over Sq 1..1024, D 64 / 112 /
              128, fp32 and bf16 K/V, G 1 and 4, the masks, rows with no
              visible key exactly zero, and on its CUDA-core kernel (fp32
              q) at the fp32 tolerance; the SSD scan on its tensor-core
              kernel (bf16 x, B, C) at the served shapes and over S
              1..1000, chunk 64 / 128, N 64 / 128, P 32 / 64, G 1 / 2,
              with and without an initial state (y 2e-2, state 2e-4), and
              on its CUDA-core kernel (fp32) at 2e-4, each launch checked
              by variant;
4. serve    - qwen1.5-0.5b at full width (24 layers, d=1024, vocab
              151,936, seeded random weights) served by
              ``repro_torch.serve.Engine`` through ``run_trace``: 16
              requests under a 32-page tier-1 quota with a 4 GB tier-2
              budget, so sequences pause, spill and fetch.  Every kernel
              launch of the run is counted (flash by variant: every
              served launch on the tensor-core kernel), and one
              prefill's and one decode step's logits are held against
              the plain path (gated with the weights upcast to fp32
              compute, on flash's CUDA-core kernel; the served bf16
              comparison is reported beside it); 4b profiles an engine
              window;
6.  pooled  - (run right after phase 4, on its model and weights)
              benchmarks/fig9_multitenant.py's smoke scenario at full
              width: three skewed tenants (hog, mid, burst) served by
              three engines from ONE 24-page ``PoolArbiter`` pool through
              ``run_multi_trace`` (then again without the page check and
              the tracer, timed), against three static 1/3 private
              engines; a lone tenant under an arbiter against a private
              engine; two tenants built with ``Engine.from_lease`` from
              one multi-tenant lease against ``Engine.local`` with
              ``kv_share``'s budget; the pooled scenario in fp32 against
              private engines with ample pools.  Checked: every request
              done, revocation fired, pooled aggregate p95 below static
              and no tenant above 1.05x its static p95, the lone tenant
              and the lease engines identical (tokens, clocks) to their
              counterparts, the fp32 pooled tokens equal to the private
              engines' (revocation fired there too), the timed rerun
              identical to the watched run, no live page in two tenants'
              tables after any step, the modeled numbers equal to the
              same scenario at smoke width on the CPU, and the paged,
              flash and RMSNorm launches exact;
4c/4d. batch - mamba2-780m (48 layers, d=1536, 8 x 500-token prompts,
              32 tokens) and zamba2-7b (81 mamba layers, d=3584, the
              shared attention block 13 times, 4 x 500-token prompts, 16
              tokens) at full width and depth through the fixed-batch
              steps ``make_prefill_step`` / ``make_decode_step``, launch
              counts checked exactly (every served SSD launch on the
              tensor-core kernel, the fp32-gated checks' on the CUDA-core
              one), logits held against the plain path as in phase 4; 4e
              profiles a mamba2 decode window;
5. times    - each kernel's time (CUDA graphs of back-to-back calls,
              timed with CUDA events, median of trials) beside its plain
              version, a PyTorch library call where one computes the
              same function (for flash, SDPA in fp32 and, as
              ``library_bf16_ms``, on bf16 K/V), and the bound from the
              H100's published peaks, at each path's shapes (paged at
              the engine's 8-row and 1-row decode buckets; flash at
              qwen's 128 / 256 / 512 buckets and zamba2's prefill and
              decode; RMSNorm at 512 and 8 rows of 1024, 8 of 1536 and
              3072, 2000 of 3584 and 7168; the SSD scan at mamba2's and
              zamba2's prefill);
then the ``launches`` and ``kernels`` lines (phase 6's launches among
the paths), and the contract line ``{"ok": true, "device": {...}}``,
last.

It imports torch, numpy and ``repro_torch`` only (no JAX).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SSD_TOL = 2e-4                  # fp32 SSD outputs: sums run in another order
PROMPT_LENS = (120, 250, 500)   # the full-width trace's prompt lengths


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, n_inputs: int = 1, reps: int = 20, trials: int = 7):
    """Median device time of one ``fn(i)`` call: ``reps`` calls (cycling
    ``i`` over ``n_inputs`` input copies, so an input set larger than L2
    is read cold) captured in a CUDA graph, replayed ``trials`` times
    between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i % n_inputs)
    graph.replay()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def within(got, want, tol) -> bool:
    import torch
    return bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))


def paged_inputs(gen, B, H, KV, D, ps, PMAX, lengths, q_dtype, kv_dtype,
                 device):
    """One decode batch over a pool of B*PMAX + 1 pages, each row on its
    own shuffled pages."""
    import torch
    P = B * PMAX + 1
    q = torch.randn(B, H, D, generator=gen, device=device).to(q_dtype)
    kp = torch.randn(P, ps, KV, D, generator=gen, device=device).to(kv_dtype)
    vp = torch.randn(P, ps, KV, D, generator=gen, device=device).to(kv_dtype)
    perm = torch.randperm(P - 1, generator=gen, device=device)
    table = perm.reshape(B, PMAX).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, kp, vp, table, lens


def ssd_inputs(gen, B, S, H, G, N, dtype, device, P=64):
    """SSD scan inputs: x and B/C in ``dtype``, fp32 dt > 0, A < 0, D = 1
    (the reference suite's scales)."""
    import torch
    x = torch.randn(B, S, H, P, generator=gen, device=device).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device=device))
    A = -torch.exp(0.5 * torch.randn(H, generator=gen, device=device))
    Bm, Cm = ((torch.randn(B, S, G, N, generator=gen, device=device)
               / N ** 0.5).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm, torch.ones(H, device=device)


def kernel_checks(device):
    import itertools

    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}

    def record(name, case, got, want, tol):
        torch.cuda.synchronize()
        e = max_err(got, want)
        ok = within(got, want, tol) and bool(torch.isfinite(got).all())
        emit({"phase": "kernels", "kernel": name, "case": case,
              "max_abs_err": e, "tol": tol, "ok": ok})
        check(ok, f"{name} {case}: max err {e} > tol {tol}")
        return e

    # paged: the serving path's shape, bf16 queries on an fp32 pool
    for B, lens in ((1, [300]), (8, [0, 1, 64, 65, 200, 333, 512, 576])):
        args = paged_inputs(gen, B, 16, 16, 64, 64, 16, lens, bf16, f32,
                            device)
        got = paged_decode_attention(*args)
        want = ref.paged_attention_ref(*args)
        errs["paged_attention"] = record(
            "paged_attention", f"B={B} H=KV=16 D=64 ps=64 q=bf16 pages=fp32",
            got, want, TOL["bfloat16"])
        if 0 in lens:
            check(bool((got[lens.index(0)] == 0).all()),
                  "paged: a zero-length row is not exactly zero")
    args = paged_inputs(gen, 4, 32, 8, 128, 16, 12, [0, 5, 100, 191],
                        f32, f32, device)
    record("paged_attention", "B=4 H=32 KV=8 D=128 ps=16 window=40 fp32",
           paged_decode_attention(*args, sliding_window=40),
           ref.paged_attention_ref(*args, sliding_window=40),
           TOL["float32"])

    # bitwise layout invariance: the same logical KV on other pages
    q, kp, vp, table, lens = paged_inputs(
        gen, 8, 16, 16, 64, 64, 16, [576, 3, 64, 129, 0, 400, 511, 250],
        bf16, f32, device)
    perm = torch.randperm(kp.shape[0], generator=gen, device=device)
    kp2 = torch.empty_like(kp)
    vp2 = torch.empty_like(vp)
    kp2[perm] = kp
    vp2[perm] = vp
    table2 = perm[table.long()].to(torch.int32)
    out1 = paged_decode_attention(q, kp, vp, table, lens)
    out2 = paged_decode_attention(q, kp2, vp2, table2, lens)
    torch.cuda.synchronize()
    same = bool(torch.equal(out1, out2))
    emit({"phase": "kernels", "kernel": "paged_attention",
          "case": "bitwise layout invariance", "ok": same})
    check(same, "paged: output changed with the physical page layout")
    # bitwise row independence: each row decoded alone (B = 1, with the
    # full table row and with one cut to its live pages) equals its row
    # of the B = 8 batch, as the engine moves rows between buckets
    alone_ok = True
    for b, n in enumerate(lens.tolist()):
        for width in (table.shape[1], max(1, -(-n // 64))):
            one = paged_decode_attention(
                q[b:b + 1].contiguous(), kp, vp,
                table[b:b + 1, :width].contiguous(), lens[b:b + 1])
            alone_ok &= bool(torch.equal(one[0], out1[b]))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "paged_attention",
          "case": "bitwise row independence, B=1 vs B=8", "ok": alone_ok})
    check(alone_ok, "paged: a row's output changed with its batch")
    # a bf16 pool of 16-token pages, GQA G=4, a 40-token window whose
    # start falls inside a 64-position split for most rows
    args = paged_inputs(gen, 8, 32, 8, 64, 16, 16,
                        [0, 1, 16, 17, 100, 130, 250, 256], bf16, bf16,
                        device)
    got = paged_decode_attention(*args, sliding_window=40)
    record("paged_attention", "B=8 H=32 KV=8 D=64 ps=16 window=40 q=bf16 "
           "pages=bf16", got,
           ref.paged_attention_ref(*args, sliding_window=40),
           TOL["bfloat16"])
    check(bool((got[0] == 0).all()),
          "paged: a zero-length row is not exactly zero")
    # the pooled path's shape (phase 6): bf16 q over an fp32 pool of
    # 16-token pages, H=KV=16, D=64, a table of 8 pages, so each
    # 64-position split crosses 4 pages; then each row decoded alone and
    # in pairs (the engine's 1- and 2-row buckets) equals its row of B=4
    for lens in ([0, 17, 65, 128], [1, 33, 64, 100]):
        q, kp, vp, table, lt = paged_inputs(gen, 4, 16, 16, 64, 16, 8, lens,
                                            bf16, f32, device)
        out4 = paged_decode_attention(q, kp, vp, table, lt)
        record("paged_attention", f"B=4 H=KV=16 D=64 ps=16 pages=8 "
               f"lens={lens} q=bf16 pages=fp32", out4,
               ref.paged_attention_ref(q, kp, vp, table, lt),
               TOL["bfloat16"])
        if 0 in lens:
            check(bool((out4[lens.index(0)] == 0).all()),
                  "paged: a zero-length row is not exactly zero")
        alone_ok = True
        for b, n in enumerate(lens):
            for width in (table.shape[1], max(1, -(-n // 16))):
                one = paged_decode_attention(
                    q[b:b + 1].contiguous(), kp, vp,
                    table[b:b + 1, :width].contiguous(), lt[b:b + 1])
                alone_ok &= bool(torch.equal(one[0], out4[b]))
        for b in (0, 2):
            two = paged_decode_attention(q[b:b + 2].contiguous(), kp, vp,
                                         table[b:b + 2].contiguous(),
                                         lt[b:b + 2])
            alone_ok &= bool(torch.equal(two, out4[b:b + 2]))
        torch.cuda.synchronize()
        emit({"phase": "kernels", "kernel": "paged_attention",
              "case": f"bitwise row independence ps=16, B=1 and B=2 vs "
                      f"B=4, lens={lens}", "ok": alone_ok})
        check(alone_ok, "paged ps=16: a row's output changed with its batch")

    # flash, bf16 q (the tensor-core kernel): every Sq bucket and a
    # decode query, each head_dim, K/V as the fp32 cache holds them and in
    # bf16, MHA and GQA G=4; then the masks the served paths use
    flash_grid = [(Sq, D, kv, G) for Sq in (1, 15, 64, 65, 130, 500, 512, 1024)
                  for D in (64, 112, 128) for kv in (f32, bf16) for G in (1, 4)]
    for Sq, D, kv, G in flash_grid:
        H = 8 if Sq <= 512 else 4
        q = torch.randn(1, Sq, H, D, generator=gen, device=device).to(bf16)
        k, v = (torch.randn(1, Sq, H // G, D, generator=gen,
                            device=device).to(kv) for _ in range(2))
        got = flash_attention(q, k, v, causal=True)
        with ops.plain_versions():
            want = ops.flash_attention(q, k, v, causal=True)
        e = record("flash_attention",
                   f"B=1 Sq=Skv={Sq} H={H} G={G} D={D} q=bf16 "
                   f"kv={str(kv)[6:]}", got, want, TOL["bfloat16"])
        if (Sq, D, kv, G) == (512, 64, f32, 1):
            errs["flash_attention"] = e
    # window, q_offset and kv_len < Skv together; with window 8 and
    # kv_len 13, rows 20.. see no key and must be exact zeros
    for D, kv in ((64, f32), (112, f32), (128, bf16)):
        q = torch.randn(2, 70, 8, D, generator=gen, device=device).to(bf16)
        k, v = (torch.randn(2, 96, 2, D, generator=gen, device=device).to(kv)
                for _ in range(2))
        for kw in (dict(sliding_window=24, q_offset=10, kv_len=80),
                   dict(sliding_window=8, q_offset=0, kv_len=13)):
            got = flash_attention(q, k, v, causal=True, **kw)
            with ops.plain_versions():
                want = ops.flash_attention(q, k, v, causal=True, **kw)
            record("flash_attention", f"GQA G=4 D={D} kv={str(kv)[6:]} "
                   + " ".join(f"{a}={b}" for a, b in kw.items()),
                   got, want, TOL["bfloat16"])
            if kw["kv_len"] == 13:
                zero = bool((got[:, 20:] == 0).all()
                            and (got[:, :20] != 0).any())
                emit({"phase": "kernels", "kernel": "flash_attention",
                      "case": f"D={D} rows with no visible key are exact "
                              f"zeros", "ok": zero})
                check(zero, "flash: a row with no visible key is not zero")
    # fp32 q: the CUDA-core kernel, held at the fp32 tolerance
    q = torch.randn(2, 70, 8, 128, generator=gen, device=device)
    k = torch.randn(2, 96, 2, 128, generator=gen, device=device)
    v = torch.randn(2, 96, 2, 128, generator=gen, device=device)
    for D in (64, 112, 128):
        record("flash_attention",
               f"fp32 q GQA G=4 D={D} window=24 q_offset=10 kv_len=80",
               flash_attention(q[..., :D].contiguous(), k[..., :D].contiguous(),
                               v[..., :D].contiguous(), causal=True,
                               sliding_window=24, q_offset=10, kv_len=80),
               ref.attention_ref(q[..., :D].transpose(1, 2),
                                 k[..., :D].transpose(1, 2),
                                 v[..., :D].transpose(1, 2),
                                 sliding_window=24, q_offset=10,
                                 kv_len=80).transpose(1, 2),
               TOL["float32"])

    # flash at head_dim 112: zamba2's shared block, prefill over the fp32
    # contiguous cache (kv_len masks its unwritten tail) and one decode
    # query at an offset
    q = torch.randn(2, 500, 32, 112, generator=gen, device=device).to(bf16)
    k = torch.randn(2, 516, 32, 112, generator=gen, device=device)
    v = torch.randn(2, 516, 32, 112, generator=gen, device=device)
    for Sq, off in ((500, 0), (1, 507)):
        args = (q[:, :Sq].contiguous(), k, v)
        kw = dict(causal=True, q_offset=off, kv_len=off + Sq)
        got = flash_attention(*args, **kw)
        with ops.plain_versions():
            want = ops.flash_attention(*args, **kw)
        e = record("flash_attention",
                   f"B=2 Sq={Sq} Skv=516 kv_len={off + Sq} H=KV=32 D=112 "
                   f"q=bf16 kv=fp32", got, want, TOL["bfloat16"])
        if Sq == 500:
            errs["flash_attention_d112"] = e

    # ssd: the serving shapes (bf16 x and B/C, fp32 dt, the zero fp32
    # state the prefill passes from the cache) on the tensor-core kernel,
    # y at the bf16 tolerance and the fp32 state at 2e-4; then the
    # tensor-core grid (S 1..1000, chunk 64 / 128, N 64 / 128, P 32 / 64,
    # G 1 / 2, with and without an initial state); then fp32 cases with a
    # random initial state, G = 2 and a prompt shorter than one chunk on
    # the CUDA-core kernel
    def ssd_case(variant, tag, args, chunk, h0, y_tol, emit_each=True):
        kernels.reset_launch_counts()
        y, h = ssd_scan(*args, chunk=chunk, init_state=h0)
        got = kernels.variant_counts()
        check(got[f"ssd_scan.{variant}"] == 1
              and kernels.launch_counts()["ssd_scan"] == 1,
              f"ssd {tag}: ran on {got}, expected the {variant} kernel")
        wy, wh = ref.ssd_chunked_ref(*args, chunk, init_state=h0)
        if emit_each:
            e = record("ssd_scan", f"{tag} y", y, wy, y_tol)
            record("ssd_scan", f"{tag} state", h, wh, SSD_TOL)
            return e, 0.0
        torch.cuda.synchronize()
        ok = (within(y, wy, y_tol) and within(h, wh, SSD_TOL)
              and bool(torch.isfinite(y).all()))
        check(ok, f"ssd {tag}: y err {max_err(y, wy)}, state err "
              f"{max_err(h, wh)}")
        return max_err(y, wy), max_err(h, wh)

    for arch, B, H, N in (("mamba2", 8, 48, 128), ("zamba2", 4, 112, 64)):
        args = ssd_inputs(gen, B, 500, H, 1, N, bf16, device)
        h0 = torch.zeros(B, H, 64, N, device=device)
        e, _ = ssd_case("tc", f"{arch} B={B} S=500 H={H} P=64 N={N} G=1 "
                        f"Q=128 bf16", args, 128, h0, TOL["bfloat16"])
        if arch == "mamba2":
            errs["ssd_scan"] = e
    worst = [0.0, 0.0]
    n_cases = 0
    for S in (1, 100, 128, 129, 500, 1000):
        for chunk, N, P, G, init in itertools.product(
                (64, 128), (64, 128), (32, 64), (1, 2), (False, True)):
            args = ssd_inputs(gen, 2, S, 4, G, N, bf16, device, P=P)
            h0 = (torch.randn(2, 4, P, N, generator=gen, device=device)
                  if init else None)
            ey, eh = ssd_case("tc", f"S={S} chunk={chunk} N={N} P={P} "
                              f"G={G} init={init}", args, chunk, h0,
                              TOL["bfloat16"], emit_each=False)
            worst = [max(worst[0], ey), max(worst[1], eh)]
            n_cases += 1
    emit({"phase": "kernels", "kernel": "ssd_scan",
          "case": f"tensor-core grid, {n_cases} cases (B=2 H=4 bf16)",
          "max_abs_err_y": worst[0], "tol_y": TOL["bfloat16"],
          "max_abs_err_state": worst[1], "tol_state": SSD_TOL, "ok": True})
    for case, (B, S, H, G, N, chunk) in {
            "fp32 init_state": (2, 300, 8, 1, 128, 128),
            "fp32 G=2 init_state": (2, 260, 8, 2, 64, 64),
            "fp32 S=100<Q init_state": (3, 100, 4, 1, 128, 128)}.items():
        args = ssd_inputs(gen, B, S, H, G, N, f32, device)
        h0 = torch.randn(B, H, 64, N, generator=gen, device=device)
        ssd_case("f32", f"B={B} S={S} H={H} G={G} N={N} chunk={chunk} "
                 f"{case}", args, chunk, h0, SSD_TOL)

    # rmsnorm: the model's rows and widths, activations and scale in the
    # compute dtype.  qwen1.5-0.5b: d = 64 (qk rows) and 1024; the
    # recurrent paths: d_model 1536 / 3584 and the gated norm's d_inner
    # 3072 / 7168 (d > 2048: a 256-thread block per row), at decode's 4 /
    # 8 rows, the logits check's 500 and a prefill's 4000 (mamba2: 8 x
    # 500); then 512 rows (qwen's largest bucket), 3 / 33 (not a multiple
    # of the rows a block takes), d = 1000 (vectors, 125 a row) and 1001
    # (the scalar branch: a tail, and rows not 16-byte aligned)
    grid = [(rows, d, bf16) for rows in (1, 7, 300) for d in (64, 1024)]
    grid += [(rows, d, dt) for d in (1536, 3072, 3584, 7168)
             for rows in (4, 8, 500, 4000) for dt in (bf16, f32)]
    grid += [(rows, d, dt) for rows in (3, 33, 512, 4000)
             for d in (64, 1000, 1001, 1024) for dt in (bf16, f32)]
    for rows, d, dt in grid:
        x = torch.randn(rows, d, generator=gen, device=device).to(dt)
        s = (1 + 0.1 * torch.randn(d, generator=gen, device=device)).to(dt)
        name = str(dt).split(".")[-1]
        e = record("rmsnorm", f"rows={rows} d={d} {name}", rmsnorm(x, s),
                   ref.rmsnorm_ref(x, s), TOL[name])
        if dt == bf16:
            errs["rmsnorm"] = max(errs.get("rmsnorm", 0.0), e)
    # a row view that starts 2 bytes past a 16-byte boundary
    x = torch.randn(33 * 1024 + 1, generator=gen, device=device).to(bf16)
    x = x[1:].view(33, 1024)
    s = torch.ones(1024, device=device, dtype=bf16)
    record("rmsnorm", "rows=33 d=1024 bf16 misaligned", rmsnorm(x, s),
           ref.rmsnorm_ref(x, s), TOL["bfloat16"])
    return errs


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------

def serve_full_width(device):
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tiering import KVBudget
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.serve import (Engine, EngineConfig, latency_summary,
                                   run_trace, synthetic_trace)

    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    tracer = Tracer(1 << 20)
    engine = Engine.local(
        model, EngineConfig(max_slots=8, max_seq=1024, page_size=64),
        generator=gen, budget=KVBudget(tier1_pages=32, tier2_bytes=4e9,
                                       page_size=64),
        tracer=tracer, device=device)
    # prompts end a few tokens short of a page boundary, so decode grows
    # each sequence by a page: page-aligned prompts with 64 new tokens
    # never outgrow their admission pages, and no quota could then force
    # a spill without failing a request OOM
    trace = synthetic_trace(16, prompt_lens=PROMPT_LENS,
                            max_new_tokens=64, mean_interarrival_s=0.002,
                            vocab=cfg.vocab, seed=0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    handles = run_trace(engine, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    variants = kernels.variant_counts()

    stats = engine.stats()
    names = [e.name for e in tracer.events()]
    decodes, prefills = names.count("decode"), names.count("prefill")
    L = cfg.n_layers
    emit({"phase": "serve", "arch": cfg.name, "layers": L,
          "d_model": cfg.d_model, "vocab": cfg.vocab,
          "requests": len(handles), "wall_s": wall,
          "tokens_decoded": stats["tokens_decoded"],
          "tokens_per_s": stats["tokens_decoded"] / wall,
          "prefills": prefills, "decode_steps": decodes,
          "launches": counts, "kernel_variants": variants,
          "latency_modeled": latency_summary(handles),
          "kv": stats["kv"], "preempts": stats["preempts"],
          "swaps": stats["preempt_swaps"],
          "recomputes": stats["preempt_recomputes"],
          "trace_dropped": tracer.dropped})
    check(tracer.dropped == 0, "trace ring dropped events")
    check(stats["completed"] == 16 and stats["failed_oom"] == 0,
          f"not every request finished: {stats['completed']} done, "
          f"{stats['failed_oom']} failed OOM")
    check(all(len(h.tokens) == 64 and all(0 <= t < cfg.vocab
                                           for t in h.tokens)
              for h in handles), "a request's tokens are out of range")
    check(stats["kv"]["spills"] > 0 and stats["kv"]["fetches"] > 0,
          f"no spill/fetch under the 32-page quota: {stats['kv']}")
    check(counts["paged_attention"] == decodes * L,
          f"paged launches {counts['paged_attention']} != "
          f"{decodes} decode steps x {L}")
    check(counts["flash_attention"] == prefills * L,
          f"flash launches {counts['flash_attention']} != "
          f"{prefills} prefills x {L}")
    check_flash_variant(cfg.name, cfg.compute_dtype, variants,
                        counts["flash_attention"])
    check(counts["rmsnorm"] == (decodes + prefills) * (2 * L + 1),
          f"rmsnorm launches {counts['rmsnorm']} != "
          f"{decodes + prefills} calls x {2 * L + 1}")
    # the served bf16 path, kernels vs plain: reported, not gated — bf16
    # rounding flips compound over 24 random-weight layers (phase 3
    # gates each kernel at these shapes in bf16)
    logits_check(model, engine.params, trace[0].prompt_tokens, device,
                 gate=False, n_flash=(L, 0))
    # the same weights, upcast exactly, computed in fp32: gated
    model32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                          device=device)
    logits_check(model32, model32.load(engine.params),
                 trace[0].prompt_tokens, device, gate=True, n_flash=(L, 0))
    del model32
    profile_window(model, engine.params, device)
    return counts, variants, model, engine.params


def profile_window(model, params, device):
    """Where the serving time goes: 8 requests of 250 prompt tokens and
    32 new tokens arriving at once, on the same model and engine shape
    without a quota, run twice plain (the second timed) and once under
    ``torch.profiler``.  The device's busy share is the profiled
    kernel and copy time over the plain run's wall time.  Reported, not
    gated."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import (Engine, EngineConfig, burst_trace,
                                   run_trace)

    def run():
        eng = Engine.local(model, EngineConfig(max_slots=8, max_seq=1024,
                                               page_size=64),
                           params=params, device=device)
        trace = burst_trace(8, prompt_len=250, max_new_tokens=32,
                            vocab=model.cfg.vocab, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_trace(eng, trace)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, eng.steps

    run()
    wall, steps = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall, _ = run()
    emit({"phase": "profile", "requests": 8, "engine_steps": steps,
          "wall_s": wall, "profiled_wall_s": profiled_wall,
          **device_time(prof, wall)})


def device_time(prof, wall: float):
    """The profiled run's device time by kernel name: the busy share is
    the kernel and copy time over ``wall``, the plain run's time."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_busy_s": busy_s if by_name else None,
            "device_busy_share": busy_s / wall if by_name else None,
            "top_device_time": [{"name": k[:90], "ms": t / 1e3, "calls": n}
                                for k, (t, n) in top]}


def check_flash_variant(what, compute, variants, n):
    """``n`` flash launches, all on the variant of the compute dtype: the
    tensor-core kernel for bf16 q, the CUDA-core kernel for fp32 q."""
    on = "tc" if compute == "bfloat16" else "f32"
    got = {v: variants[f"flash_attention.{v}"] for v in ("tc", "f32")}
    want = {v: n if v == on else 0 for v in got}
    check(got == want, f"{what} ({compute}): flash launches by variant "
          f"{got} != {want}")
    return {"launches": got, "expected": want}


def check_ssd_variant(what, compute, variants, n):
    """``n`` SSD launches, all on the variant of the compute dtype: the
    tensor-core kernel for bf16 x, B and C, the CUDA-core kernel for
    fp32."""
    on = "tc" if compute == "bfloat16" else "f32"
    got = {v: variants[f"ssd_scan.{v}"] for v in ("tc", "f32")}
    want = {v: n if v == on else 0 for v in got}
    check(got == want, f"{what} ({compute}): ssd launches by variant "
          f"{got} != {want}")
    return {"launches": got, "expected": want}


def check_step_variant(model, step, n, n_ssd=0):
    """The kernel path of a logits check's ``step`` launched flash ``n``
    times and the SSD scan ``n_ssd`` times, each on its compute dtype's
    variant."""
    from repro_torch import kernels
    cfg = model.cfg
    variants = kernels.variant_counts()
    emit({"phase": "launches", "arch": cfg.name,
          "compute": cfg.compute_dtype,
          "check": f"{step} logits: flash and ssd launches by variant",
          **check_flash_variant(f"{cfg.name} {step}", cfg.compute_dtype,
                                variants, n),
          "ssd": check_ssd_variant(f"{cfg.name} {step}", cfg.compute_dtype,
                                   variants, n_ssd)})


def logits_check(model, params, prompt, device, gate: bool, n_flash):
    """One prefill and one decode step of the served model through the
    kernels and through the plain versions, on the same inputs; with
    ``gate`` a mismatch beyond the bf16 tolerance fails the run.
    ``n_flash``: the flash launches of the kernel path's prefill and
    decode, checked by variant."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops

    cfg = model.cfg
    plen, ps = len(prompt), 64
    bucket = -(-plen // ps) * ps
    tokens = torch.zeros((1, bucket), dtype=torch.long, device=device)
    tokens[0, :plen] = torch.as_tensor(prompt, device=device)

    def prefill():
        cache = model.init_cache(1, bucket, dtype=torch.float32)
        return model.prefill_at(params, {"tokens": tokens}, cache, plen - 1)

    kernels.reset_launch_counts()
    got, cache = prefill()
    check_step_variant(model, "prefill", n_flash[0])
    with ops.plain_versions():
        want, _ = prefill()
    report("prefill", got, want, model.cfg.compute_dtype, gate)

    # the prompt's pages, plus the page the decoded token lands in
    n_filled, n_pages = bucket // ps, plen // ps + 1
    pools = {n: torch.zeros((cfg.n_layers, n_pages + 1, ps, cfg.n_kv_heads,
                             cfg.head_dim), device=device)
             for n in ("k", "v")}
    for n in pools:
        pools[n][:, :n_filled] = cache[n][:, 0].reshape(
            cfg.n_layers, n_filled, ps, cfg.n_kv_heads, cfg.head_dim)
    table = torch.arange(n_pages, dtype=torch.int32,
                         device=device)[None, :].contiguous()
    lengths = torch.tensor([plen], dtype=torch.int32, device=device)
    tok = torch.argmax(got[:, -1], dim=-1)[:, None]
    kernels.reset_launch_counts()
    got, _ = model.decode_paged(params, tok, {n: p.clone()
                                              for n, p in pools.items()},
                                table, lengths)
    check_step_variant(model, "decode", n_flash[1])
    with ops.plain_versions():
        want, _ = model.decode_paged(params, tok, pools, table, lengths)
    report("decode", got, want, model.cfg.compute_dtype, gate)


def report(step, got, want, compute, gate, phase="serve", arch=None):
    import torch
    torch.cuda.synchronize()
    e = max_err(got, want)
    ok = within(got, want, TOL["bfloat16"]) and bool(
        torch.isfinite(got).all())
    same_top = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    emit({"phase": phase, **({"arch": arch} if arch else {}),
          "check": f"{step} logits, kernels vs plain",
          "compute": compute, "shape": list(got.shape), "max_abs_err": e,
          "logit_absmax": float(want.float().abs().max()),
          "same_argmax": same_top, "tol": TOL["bfloat16"], "gated": gate,
          "ok": ok})
    if gate:
        check(ok, f"{step} logits ({compute}): kernels vs plain max err {e}")


# ---------------------------------------------------------------------------
# phases 4c-4e: the recurrent families through the fixed-batch steps
# ---------------------------------------------------------------------------

# (mamba layers, shared-block invocations) of each full-width config:
# 48 Mamba2 layers; 81 Mamba2 layers with the shared block every 6
LAYOUT = {"mamba2-780m": (48, 0), "zamba2-7b": (81, 81 // 6)}


def expected_launches(cfg, generate: int):
    """Kernel launches of one prefill and ``generate - 1`` decode steps:
    the SSD scan once per mamba layer at prefill (decode runs the plain
    one-token recurrence), flash once per shared-block invocation per
    forward, RMSNorm twice per block plus the final norm per forward."""
    n_mamba, n_attn = LAYOUT[cfg.name]
    check(cfg.n_layers == n_mamba, f"{cfg.name}: {cfg.n_layers} layers, "
          f"expected {n_mamba}")
    return {"paged_attention": 0, "flash_attention": n_attn * generate,
            "rmsnorm": (2 * n_mamba + 2 * n_attn + 1) * generate,
            "ssd_scan": n_mamba}


def fixed_batch_full_width(arch, device, batch, prompt, generate, *,
                           profile_steps=0):
    """``batch`` seeded random prompts of ``prompt`` tokens prefilled,
    then greedy-decoded to ``generate`` tokens per row, at full width and
    depth through ``repro_torch.launch.serve``'s fixed-batch loop
    (``make_prefill_step`` / ``make_decode_step`` over an fp32 cache).
    Launch counts are checked exactly; tokens/s is over the timed
    decode, ending in ``torch.cuda.synchronize()``."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (fixed_batch_generate,
                                          fixed_batch_inputs)
    from repro_torch.models.api import build_model
    from repro_torch.runtime.serve import make_decode_step

    cfg = get_config(arch)
    model = build_model(cfg, device=device)
    raw, prompts = fixed_batch_inputs(model, batch, prompt, 0, device)
    params = model.load(raw)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    run = fixed_batch_generate(model, params, prompts, generate, device)
    counts = kernels.launch_counts()
    variants = kernels.variant_counts()

    toks = run["tokens"]
    want = expected_launches(cfg, generate)
    emit({"phase": "batch", "arch": cfg.name, "family": cfg.family,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "param_dtype": cfg.param_dtype,
          "compute_dtype": cfg.compute_dtype, "batch": batch,
          "prompt": prompt, "generated": toks.shape[1],
          "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
          "decode_tokens_per_s": run["decode_tokens_per_s"],
          "launches": counts, "kernel_variants": variants,
          "expected_launches": want,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "sample_tokens": toks[0, :8].tolist()})
    check(counts == want, f"{cfg.name}: launches {counts} != {want}")
    check_flash_variant(cfg.name, cfg.compute_dtype, variants,
                        counts["flash_attention"])
    check_ssd_variant(cfg.name, cfg.compute_dtype, variants,
                      counts["ssd_scan"])
    check(toks.shape == (batch, generate)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{cfg.name}: tokens out of range or missing")
    check(run["logits_finite"], f"{cfg.name}: non-finite logits")

    carry = run.pop("carry")
    if profile_steps:
        profile_decode_window(params, make_decode_step(model), carry,
                              profile_steps)
    del carry, run
    one = prompts[:1]
    # the served bf16 path, kernels vs plain: reported, not gated (bf16
    # rounding flips compound over the layers, ROADMAP C-port2)
    n_attn = LAYOUT[cfg.name][1]
    recurrent_logits_check(model, params, one, gate=False, n_flash=n_attn)
    del params
    torch.cuda.empty_cache()
    # the same weights computed in fp32 (the fp32 draw itself: no copy):
    # gated
    model32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                          device=device)
    recurrent_logits_check(model32, model32.load(raw), one, gate=True,
                           n_flash=n_attn)
    return counts, variants


def recurrent_logits_check(model, params, tokens, gate: bool, n_flash):
    """One prefill of ``tokens`` (1, S) and one decode step from its
    cache, through the kernels and through the plain versions; both
    decode steps start from the kernel path's cache and token.  Each
    kernel-path step launches flash ``n_flash`` times (once per shared
    attention block), and the prefill the SSD scan once per mamba layer,
    checked by variant."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops

    S = tokens.shape[1]

    def prefill():
        cache = model.init_cache(1, S + 1, dtype=torch.float32)
        return model.prefill(params, {"tokens": tokens}, cache)

    kernels.reset_launch_counts()
    got, cache = prefill()
    check_step_variant(model, "prefill", n_flash,
                       n_ssd=LAYOUT[model.cfg.name][0])
    with ops.plain_versions():
        want, _ = prefill()
    report("prefill", got, want, model.cfg.compute_dtype, gate,
           phase="batch", arch=model.cfg.name)
    tok = torch.argmax(got[:, -1], dim=-1)[:, None]
    twin = {k: v.clone() for k, v in cache.items()}
    kernels.reset_launch_counts()
    got, _ = model.decode(params, tok, cache, S)
    check_step_variant(model, "decode", n_flash)
    with ops.plain_versions():
        want, _ = model.decode(params, tok, twin, S)
    report("decode", got, want, model.cfg.compute_dtype, gate,
           phase="batch", arch=model.cfg.name)


def profile_decode_window(params, decode, carry, steps: int):
    """Where the fixed-batch decode time goes: ``steps`` greedy steps
    from ``carry``, run twice plain (the second timed) and once under
    ``torch.profiler``.  Reported, not gated."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        c = carry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            _, c = decode(params, c)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    wall = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall = run()
    emit({"phase": "profile", "path": "fixed-batch decode",
          "batch": carry["tokens"].shape[0], "decode_steps": steps,
          "wall_s": wall, "profiled_wall_s": profiled_wall,
          **device_time(prof, wall)})


# ---------------------------------------------------------------------------
# phase 6: multi-tenant pooled serving (fig9's smoke scenario) at full width
# ---------------------------------------------------------------------------

# benchmarks/fig9_multitenant.py's smoke constants, restated (the smoke
# imports nothing of benchmarks/): three skewed tenants on one 24-page
# pool, 4 slots each, a 3 GB tier-2 grant split three ways
MT_PAGE, MT_PROMPT, MT_MAX_NEW, MT_SLOTS = 16, 32, 96, 4
MT_POOL_PAGES, MT_T2_BYTES = 24, 3e9
MT_TENANTS = ("hog", "mid", "burst")
MT_SHALLOW = 2      # depth of the comparison runs (b)-(e)


def mt_traffic():
    """fig9's ``_traffic(smoke=True)``: a hog of 8 requests 4 ms apart,
    a steady tenant of 4 requests 12 ms apart with half the new tokens,
    and a burst of 2 at t = 20 ms with a third of them.  Drawn with the
    smoke config's vocab, as fig9 draws them, at every width: numpy's
    ``randint`` takes more or fewer draws from the seed's stream by
    range, so another vocab would move the arrival times."""
    from repro_torch.configs import get_config
    from repro_torch.serve import synthetic_trace
    vocab = get_config("qwen1.5-0.5b", smoke=True).vocab
    hog = synthetic_trace(8, mean_interarrival_s=0.004,
                          prompt_lens=(MT_PROMPT,),
                          max_new_tokens=MT_MAX_NEW, vocab=vocab, seed=0)
    mid = synthetic_trace(4, mean_interarrival_s=0.012,
                          prompt_lens=(MT_PROMPT,),
                          max_new_tokens=MT_MAX_NEW // 2, vocab=vocab,
                          seed=1)
    burst = [dataclasses.replace(r, arrival_time=0.02)
             for r in synthetic_trace(2, mean_interarrival_s=0.0,
                                      prompt_lens=(MT_PROMPT,),
                                      max_new_tokens=MT_MAX_NEW // 3,
                                      vocab=vocab, seed=2)]
    return {"hog": hog, "mid": mid, "burst": burst}


def mt_engine(model, params, device, **kw):
    """One engine of the scenario with fig9's ``_cost_model``: modeled
    costs priced at the full-size qwen1.5-0.5b, tier-2 bandwidth scaled
    by this engine's page bytes over the full model's bf16 page, so the
    schedule does not depend on the width served."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, EngineConfig, ServeCostModel

    full = get_config("qwen1.5-0.5b")
    lease = kw.pop("lease", None)
    cfg = EngineConfig(max_slots=MT_SLOTS, max_seq=MT_PROMPT + MT_MAX_NEW,
                       page_size=MT_PAGE)
    if lease is not None:
        eng = Engine.from_lease(model, lease, cfg, params=params,
                                device=device, **kw)
    else:
        eng = Engine.local(model, cfg, params=params, device=device, **kw)
    cm = ServeCostModel.from_fabric(2.0 * full.param_count())
    full_page = (2 * full.n_layers * MT_PAGE * full.n_kv_heads
                 * full.head_dim * 2)
    eng.cost = dataclasses.replace(
        cm, tier2_bw=cm.tier2_bw * eng.kv.page_bytes / full_page)
    return eng


def mt_pooled(model, params, device, tracer=None, watch=False):
    """(a) the tenants on one ``PoolArbiter`` through ``run_multi_trace``;
    with ``watch`` the pool's page conservation (no live page in two
    tenants' tables) is checked at the end of every engine step."""
    from repro_torch.serve import KVBudget, PoolArbiter, run_multi_trace

    arb = PoolArbiter(MT_POOL_PAGES, page_size=MT_PAGE, tracer=tracer)
    n = len(MT_TENANTS)
    engines = {t: mt_engine(model, params, device, arbiter=arb, tenant=t,
                            tracer=tracer,
                            budget=KVBudget(tier2_bytes=MT_T2_BYTES / n,
                                            page_size=MT_PAGE))
               for t in MT_TENANTS}
    checked = [0]
    if watch:
        for eng in engines.values():
            def step(orig=eng.step):
                dt = orig()
                arb.check_conservation()
                checked[0] += 1
                return dt
            eng.step = step
    traffic = mt_traffic()
    lists = run_multi_trace([(engines[t], traffic[t]) for t in MT_TENANTS])
    return arb, engines, dict(zip(MT_TENANTS, lists)), checked[0]


def mt_static(model, params, device):
    """(b) static 1/3 partitions: each tenant a private engine with a
    third of the pool and of the tier-2 grant."""
    from repro_torch.serve import KVBudget, run_trace
    n = len(MT_TENANTS)
    traffic = mt_traffic()
    return {t: run_trace(mt_engine(model, params, device,
                                   budget=KVBudget(
                                       tier1_pages=MT_POOL_PAGES // n,
                                       tier2_bytes=MT_T2_BYTES / n,
                                       page_size=MT_PAGE)), traffic[t])
            for t in MT_TENANTS}


def mt_modeled(arb, engines, handles):
    """The numbers the modeled clock gives: per tenant p95, swaps,
    recomputes and every handle's clocks, and the arbiter's revoked
    pages — width-free by construction."""
    from repro_torch.serve import latency_summary
    out = {"revoked_pages": arb.revoked_pages,
           "revocations": arb.revocations,
           "recompute_drops": arb.recompute_drops}
    for t in MT_TENANTS:
        st = engines[t].stats()
        out[t] = {"p95_s": latency_summary(handles[t])["p95_s"],
                  "swaps": st["preempt_swaps"],
                  "recomputes": st["preempt_recomputes"],
                  "clocks": [(h.submit_clock, h.first_token_clock,
                              h.done_clock) for h in handles[t]]}
    return out


def same_runs(a, b) -> bool:
    """Identical tokens and handle clocks, request by request."""
    return len(a) == len(b) and all(
        x.tokens == y.tokens
        and (x.submit_clock, x.first_token_clock, x.done_clock)
        == (y.submit_clock, y.first_token_clock, y.done_clock)
        for x, y in zip(a, b))


def multitenant_full_width(model, params, device):
    """fig9's smoke scenario served on the card from one physical KV
    pool: (a) the three tenants on one ``PoolArbiter`` at full width and
    depth, every kernel launch counted and the pages checked after every
    step, then run again unwatched and untraced for the wall time; (b)
    three static 1/3 private engines; (c) a lone tenant under an 8-page
    arbiter against a private engine with that budget, on the hog's
    trace; (d) two tenants built with ``Engine.from_lease`` from one
    multi-tenant lease against ``Engine.local`` with ``kv_share``'s
    budget; (e) the pooled scenario in fp32, each tenant's tokens against
    a private engine with an ample pool, so revocation's gather, copy
    and page reuse on the card are held to a run that never revokes.
    (b)-(e) run the first ``MT_SHALLOW`` layers at full width: their
    modeled numbers do not depend on depth (checked against the CPU run
    below), and the smoke's time stays in bounds.  (a)'s and (b)'s
    modeled numbers must equal the same scenario's at smoke width on
    the CPU."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import (KVBudget, PoolArbiter, RequestStatus,
                                   latency_summary, run_multi_trace,
                                   run_trace)

    # the same scenario at smoke width on the CPU, inside this run
    small = build_model(get_config("qwen1.5-0.5b", smoke=True),
                        device="cpu")
    small_params = small.init(torch.Generator().manual_seed(0))
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # its ops are tiny: threads only wait
    t0 = time.perf_counter()
    cpu_modeled = mt_modeled(*mt_pooled(small, small_params, cpu,
                                        watch=True)[:3])
    cpu_static = mt_static(small, small_params, cpu)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)

    # (a) on the card, every kernel launch counted
    tracer = Tracer(1 << 20)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    arb, engines, fair, checked = mt_pooled(model, params, device,
                                            tracer=tracer, watch=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    variants = kernels.variant_counts()
    names = [e.name for e in tracer.events()]
    decodes, prefills = names.count("decode"), names.count("prefill")
    modeled = mt_modeled(arb, engines, fair)
    L = model.cfg.n_layers
    tokens = sum(engines[t].stats()["tokens_decoded"] for t in MT_TENANTS)
    all_fair = [h for t in MT_TENANTS for h in fair[t]]

    # (a) again without the page check and the tracer, timed: the wall
    # and tokens per wall second a deployment would see; it must repeat
    # the watched run's tokens and modeled numbers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arb_t, engines_t, timed, _ = mt_pooled(model, params, device)
    torch.cuda.synchronize()
    timed_wall = time.perf_counter() - t0
    repeat_same = (mt_modeled(arb_t, engines_t, timed) == modeled
                   and all(same_runs(timed[t], fair[t]) for t in MT_TENANTS))
    del arb_t, engines_t, timed

    # (b)-(e) at depth MT_SHALLOW: the full model's first layers
    shallow = build_model(dataclasses.replace(model.cfg,
                                              n_layers=MT_SHALLOW),
                          device=device)
    shallow_params = {**params, "layers": params["layers"][:MT_SHALLOW]}
    t0 = time.perf_counter()
    static = mt_static(shallow, shallow_params, device)
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    all_static = [h for t in MT_TENANTS for h in static[t]]
    static_clocks = {t: [(h.submit_clock, h.first_token_clock,
                          h.done_clock) for h in static[t]]
                     for t in MT_TENANTS}

    n = len(MT_TENANTS)
    hog = mt_traffic()["hog"]
    priv = run_trace(mt_engine(shallow, shallow_params, device,
                               budget=KVBudget(MT_POOL_PAGES // n,
                                               MT_T2_BYTES / n, MT_PAGE)),
                     hog)
    solo_arb = PoolArbiter(MT_POOL_PAGES // n, page_size=MT_PAGE)
    solo = run_trace(mt_engine(shallow, shallow_params, device,
                               arbiter=solo_arb, tenant="solo",
                               budget=KVBudget(tier2_bytes=MT_T2_BYTES / n,
                                               page_size=MT_PAGE)), hog)

    # (d) two tenants from one lease == Engine.local with kv_share
    traffic = mt_traffic()
    lease = smoke_pool("scalepool").lease("chip-serve", 4, tier2_gb=8,
                                          kv_gb=1, tenants=("t0", "t1"))
    pair = {"t0": traffic["mid"], "t1": traffic["burst"]}
    runs = []
    for leased in (True, False):
        a2 = PoolArbiter(MT_POOL_PAGES // 2, page_size=MT_PAGE)
        engs = {t: (mt_engine(shallow, shallow_params, device, lease=lease,
                              arbiter=a2, tenant=t) if leased else
                    mt_engine(shallow, shallow_params, device, arbiter=a2,
                              tenant=t,
                              budget=lease.kv_share(t, page_size=MT_PAGE)))
                for t in pair}
        runs.append((run_multi_trace([(engs[t], pair[t]) for t in pair]),
                     [engs[t].budget.tier2_bytes for t in pair]))

    # (e) revocation on the card against an independent run: the pooled
    # scenario in fp32 (the same weights, upcast exactly) must give each
    # tenant the tokens that a private engine with room for every slot's
    # pages gives it, though the hog's pages were revoked, spilled and
    # fetched while other tenants reused them
    shallow32 = build_model(dataclasses.replace(shallow.cfg,
                                                compute_dtype="float32"),
                            device=device)
    arb32, engines32, pooled32, _ = mt_pooled(shallow32, shallow_params,
                                              device)
    ample = MT_SLOTS * (MT_PROMPT + MT_MAX_NEW) // MT_PAGE
    private32 = {}
    for t in MT_TENANTS:
        eng = mt_engine(shallow32, shallow_params, device,
                        budget=KVBudget(ample, MT_T2_BYTES / n, MT_PAGE))
        private32[t] = (run_trace(eng, traffic[t]), eng.stats()["preempts"])
    torch.cuda.synchronize()
    revoked32 = {"revoked_pages": arb32.revoked_pages,
                 "hog_swaps": engines32["hog"].stats()["preempt_swaps"]}
    tokens_equal32 = {t: [h.tokens for h in pooled32[t]]
                      == [h.tokens for h in private32[t][0]]
                      for t in MT_TENANTS}
    del shallow32, arb32, engines32, pooled32

    per_tenant = {}
    for t in MT_TENANTS:
        st = engines[t].stats()
        per_tenant[t] = {
            "p95_fair_s": modeled[t]["p95_s"],
            "p95_static_s": latency_summary(static[t])["p95_s"],
            "swaps": modeled[t]["swaps"],
            "recomputes": modeled[t]["recomputes"],
            "requests": len(fair[t]), "tokens_decoded": st["tokens_decoded"],
            "revocation_charged_s":
                arb.stats()["tenants"][t]["revocation_charged_s"]}
    agg_fair = latency_summary(all_fair)["p95_s"]
    agg_static = latency_summary(all_static)["p95_s"]
    static_equal = static_clocks == {
        t: [(h.submit_clock, h.first_token_clock, h.done_clock)
            for h in cpu_static[t]] for t in MT_TENANTS}
    emit({"phase": "multitenant", "arch": model.cfg.name,
          "layers": L, "d_model": model.cfg.d_model,
          "comparison_layers": MT_SHALLOW,
          "tenants": per_tenant, "revoked_pages": arb.revoked_pages,
          "revocations": arb.revocations,
          "agg_p95_fair_s": agg_fair, "agg_p95_static_s": agg_static,
          "wall_s": timed_wall, "tokens_decoded": tokens,
          "tokens_per_s": tokens / timed_wall, "watched_wall_s": wall,
          "repeat_identical": repeat_same, "static_wall_s": static_wall,
          "fp32_revocation": revoked32,
          "fp32_private_preempts": {t: private32[t][1] for t in MT_TENANTS},
          "fp32_tokens_equal_private": tokens_equal32,
          "prefills": prefills, "decode_steps": decodes,
          "page_checks": checked, "launches": counts,
          "kernel_variants": variants,
          "cpu_smoke_width_s": cpu_s,
          "modeled_equal_smoke_width": modeled == cpu_modeled,
          "static_equal_smoke_width": static_equal,
          "trace_dropped": tracer.dropped})
    check(tracer.dropped == 0, "multitenant: trace ring dropped events")
    done = all(h.status is RequestStatus.DONE for h in all_fair + all_static)
    check(done and all(engines[t].stats()["failed_oom"] == 0
                       for t in MT_TENANTS),
          "multitenant: a request did not finish or failed OOM")
    check(all(len(h.tokens) == h.request.max_new_tokens
              and all(0 <= x < model.cfg.vocab for x in h.tokens)
              for h in all_fair), "multitenant: tokens missing or out of "
          "range")
    check(arb.revoked_pages > 0, "multitenant: revocation never fired")
    check(agg_fair < agg_static, f"multitenant: pooled aggregate p95 "
          f"{agg_fair} not below static {agg_static}")
    for t, v in per_tenant.items():
        check(v["p95_fair_s"] <= 1.05 * v["p95_static_s"],
              f"multitenant: {t} p95 {v['p95_fair_s']} > 1.05 x static "
              f"{v['p95_static_s']}")
    check(same_runs(priv, solo), "multitenant: a lone tenant under an "
          "arbiter differs from its private engine")
    (leased_h, leased_t2), (local_h, local_t2) = runs
    check(leased_t2 == local_t2 == [0.5e9, 0.5e9]
          and all(same_runs(a, b) for a, b in zip(leased_h, local_h)),
          "multitenant: lease-built engines differ from local ones")
    check(repeat_same, "multitenant: the unwatched rerun of (a) differs "
          "from the watched run")
    check(revoked32["revoked_pages"] > 0 and revoked32["hog_swaps"] > 0,
          f"multitenant fp32: revocation did not fire: {revoked32}")
    check(all(private32[t][1] == 0 for t in MT_TENANTS),
          "multitenant fp32: a private engine with an ample pool preempted")
    check(all(tokens_equal32.values()), f"multitenant fp32: pooled tokens "
          f"differ from private engines': {tokens_equal32}")
    check(checked > 0, "multitenant: no page check ran")
    check(modeled == cpu_modeled, f"multitenant: modeled numbers at full "
          f"width {modeled} != smoke width on the CPU {cpu_modeled}")
    check(static_equal, "multitenant: the static runs' clocks differ from "
          "the same runs at smoke width on the CPU")
    check(counts["paged_attention"] == decodes * L,
          f"multitenant: paged launches {counts['paged_attention']} != "
          f"{decodes} decode steps x {L}")
    check(counts["flash_attention"] == prefills * L,
          f"multitenant: flash launches {counts['flash_attention']} != "
          f"{prefills} prefills x {L}")
    check_flash_variant(f"{model.cfg.name} pooled", model.cfg.compute_dtype,
                        variants, counts["flash_attention"])
    check(counts["rmsnorm"] == (decodes + prefills) * (2 * L + 1),
          f"multitenant: rmsnorm launches {counts['rmsnorm']} != "
          f"{decodes + prefills} calls x {2 * L + 1}")
    return counts, variants


# ---------------------------------------------------------------------------
# phase 5: times at the serving path's shapes
# ---------------------------------------------------------------------------

def ssd_work(B, S, H, P, G, N, chunk, itemsize):
    """(bytes, flops) of one SSD scan: x, dt, B, C, A, D and the initial
    state read once, y and the final state written once; the causal half
    of each chunk's score and intra-chunk products, the carried-state
    output and the state update."""
    Q = min(chunk, S)
    tri = sum(q * (q + 1) // 2 for q in (min(Q, S - t)
                                         for t in range(0, S, Q)))
    flops = 2 * B * H * (tri * (N + P) + 2 * S * N * P)
    nbytes = (2 * B * S * H * P * itemsize + B * S * H * 4
              + 2 * B * S * G * N * itemsize + 2 * H * 4
              + 2 * B * H * P * N * 4)
    return nbytes, flops


def kernel_times(device, counts, errs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device=device).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def row(mod, name, ms, plain_ms, bound_ms, bound_by, library_ms,
            **extra):
        rows.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                     "replaces": mod.REPLACES, "launches": counts[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     **extra})

    # paged: a full decode batch (8 rows, 120..563 live tokens, the trace's
    # prompt lengths plus generated tokens), four copies of the pool so
    # the timed calls read cold K/V as a decode step does layer by layer
    lens = [130, 260, 520, 150, 300, 563, 200, 400]
    sets = [paged_inputs(gen, 8, 16, 16, 64, 64, 16, lens, bf16, f32, device)
            for _ in range(4)]
    def paged_bound(q, kp, lens):
        live = sum(lens)
        nbytes = (2 * live * 16 * 64 * kp.element_size()          # K and V
                  + 2 * q.numel() * q.element_size()              # q, out
                  + 4 * sum(-(-n // 64) for n in lens)            # table
                  + 4 * len(lens))                                # lens
        return bound(nbytes, 4 * live * 16 * 64, BF16_FLOPS)

    ms = time_ms(lambda i: pa.paged_decode_attention(*sets[i]), 4)
    plain = time_ms(lambda i: ref.paged_attention_ref(*sets[i]), 4)
    b_ms, b_by = paged_bound(sets[0][0], sets[0][1], lens)
    row(pa, "paged_attention", ms, plain, b_ms, b_by, None)
    emit({"phase": "times", "kernel": "paged_attention",
          "case": "engine decode B=8 len 130..563 H=KV=16 D=64 ps=64 "
                  "q=bf16 pages=fp32", "ms": ms, "plain_ms": plain,
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    # a one-row decode bucket: 300 tokens, 5 live splits x 16 heads
    ones = [paged_inputs(gen, 1, 16, 16, 64, 64, 16, [300], bf16, f32,
                         device) for _ in range(4)]
    ms1 = time_ms(lambda i: pa.paged_decode_attention(*ones[i]), 4)
    plain1 = time_ms(lambda i: ref.paged_attention_ref(*ones[i]), 4)
    emit({"phase": "times", "kernel": "paged_attention",
          "case": "engine decode B=1 len 300 H=KV=16 D=64 ps=64 q=bf16 "
                  "pages=fp32", "ms": ms1, "plain_ms": plain1,
          **dict(zip(("bound_ms", "bound_by"),
                     paged_bound(ones[0][0], ones[0][1], [300]))),
          "library_ms": None})

    def flash_time(B, Sq, Skv, H, D, q_offset=0, kv_len=None,
                   q_dtype=bf16):
        """(ms, plain, bound, bound_by, fp32 SDPA, bf16 SDPA) of one
        causal call over an fp32 cache: SDPA gets the keys the queries
        see, [0, kv_len), causal for a prefill from position 0, all
        visible for one decode query at the end of them."""
        n_kv = Skv if kv_len is None else kv_len
        q = torch.randn(B, Sq, H, D, generator=gen, device=device).to(q_dtype)
        k, v = (torch.randn(B, Skv, H, D, generator=gen, device=device)
                for _ in range(2))
        kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
        ms = time_ms(lambda i: fa.flash_attention(q, k, v, **kw))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        plain = time_ms(lambda i: ref.attention_ref(qt, kt, vt, **kw))
        ks, vs = kt[:, :, :n_kv], vt[:, :, :n_kv]
        q32, q16 = qt.float(), qt.to(bf16)
        ks16, vs16 = ks.to(bf16), vs.to(bf16)
        causal = Sq > 1
        lib = time_ms(lambda i: F.scaled_dot_product_attention(
            q32, ks, vs, is_causal=causal))
        lib16 = time_ms(lambda i: F.scaled_dot_product_attention(
            q16, ks16, vs16, is_causal=causal))
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * n_kv
        nbytes = (2 * q.numel() * q.element_size()
                  + 2 * B * n_kv * H * D * k.element_size())
        return (ms, plain, *bound(nbytes, 4 * D * H * B * pairs,
                                  BF16_FLOPS), lib, lib16)

    def flash_line(case, t, variant="tc", **extra):
        ms, plain, b_ms, b_by, lib, lib16 = t
        emit({"phase": "times", "kernel": "flash_attention",
              "variant": variant, "case": case, "ms": ms,
              "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": lib, "library_bf16_ms": lib16, **extra})

    # flash: the largest prefill bucket of the trace (512), bf16 q, fp32
    # cache; then the other buckets, zamba2's prefill and decode at
    # head_dim 112, and the fp32-q kernel at the 512 bucket
    ms, plain, b_ms, b_by, lib, lib16 = flash_time(1, 512, 512, 16, 64)
    row(fa, "flash_attention", ms, plain, b_ms, b_by, lib,
        library_bf16_ms=lib16)
    flash_line("qwen prefill B=1 Sq=Skv=512 H=16 D=64 q=bf16 kv=fp32",
               (ms, plain, b_ms, b_by, lib, lib16))
    for S in (128, 256):
        flash_line(f"qwen prefill B=1 Sq=Skv={S} H=16 D=64 q=bf16 kv=fp32",
                   flash_time(1, S, S, 16, 64))
    flash_line("zamba2 prefill B=4 Sq=500 Skv=516 kv_len=500 H=KV=32 "
               "D=112 q=bf16 kv=fp32",
               flash_time(4, 500, 516, 32, 112, kv_len=500),
               max_abs_err=errs["flash_attention_d112"])
    flash_line("zamba2 decode B=4 Sq=1 Skv=516 q_offset=499 kv_len=500 "
               "H=KV=32 D=112 q=bf16 kv=fp32",
               flash_time(4, 1, 516, 32, 112, q_offset=499, kv_len=500))
    flash_line("fp32 q B=1 Sq=Skv=512 H=16 D=64 kv=fp32",
               flash_time(1, 512, 512, 16, 64, q_dtype=f32), variant="f32")

    # rmsnorm: bf16 rows at d_model (the input was just written by the
    # previous op, so it is timed warm): qwen's 512-row bucket, decode's
    # 8 rows at each path's width, zamba2's prefill (4 x 500 rows) at
    # d_model and d_inner
    def rms_time(n, d):
        x = torch.randn(n, d, generator=gen, device=device).to(bf16)
        s = (1 + 0.1 * torch.randn(d, generator=gen, device=device)).to(bf16)
        ms = time_ms(lambda i: rn.rmsnorm(x, s))
        plain = time_ms(lambda i: ref.rmsnorm_ref(x, s))
        lib = (time_ms(lambda i: F.rms_norm(x, (d,), weight=s, eps=1e-6))
               if hasattr(F, "rms_norm") else None)
        return (ms, plain, *bound(2 * x.numel() * 2 + d * 2, 4 * x.numel(),
                                  BF16_FLOPS), lib)

    for n, d in ((512, 1024), (8, 1024), (8, 1536), (8, 3072), (2000, 3584),
                 (2000, 7168)):
        ms, plain, b_ms, b_by, lib = rms_time(n, d)
        if (n, d) == (512, 1024):
            row(rn, "rmsnorm", ms, plain, b_ms, b_by, lib)
        emit({"phase": "times", "kernel": "rmsnorm",
              "case": f"rows={n} d={d} bf16", "ms": ms, "plain_ms": plain,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})

    # ssd: the prefill's shapes (bf16 x and B/C, fp32 dt, the cache's
    # zero fp32 state) on the tensor-core kernel, two input copies cycled
    # so each call reads cold
    for arch, B, H, N in (("mamba2", 8, 48, 128), ("zamba2", 4, 112, 64)):
        sets = [ssd_inputs(gen, B, 500, H, 1, N, bf16, device)
                + (torch.zeros(B, H, 64, N, device=device),)
                for _ in range(2)]

        ms = time_ms(lambda i: ssd.ssd_scan(
            *sets[i][:6], chunk=128, init_state=sets[i][6]), 2)
        plain = time_ms(lambda i: ref.ssd_chunked_ref(
            *sets[i][:6], 128, init_state=sets[i][6]), 2)
        b_ms, b_by = bound(*ssd_work(B, 500, H, 64, 1, N, 128, 2),
                           BF16_FLOPS)
        if arch == "mamba2":
            row(ssd, "ssd_scan", ms, plain, b_ms, b_by, None, variant="tc")
        emit({"phase": "times", "kernel": "ssd_scan",
              "case": f"{arch} prefill B={B} S=500 H={H} P=64 N={N} G=1 "
                      f"Q=128 bf16", "ms": ms, "plain_ms": plain,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
              "variant": "tc"})
    return rows


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip smoke needs a CUDA device; none is visible")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False})

    t0 = time.perf_counter()
    lib = _build.build(force=True)
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib), "sources": list(_build.SOURCES)})
    for line in (lib.parent / "build.log").read_text().splitlines():
        if ("registers" in line or "spill" in line or "entry" in line
                or line.startswith("==")):
            print(line, file=sys.stderr)

    errs = kernel_checks(device)
    # each path runs with the counts set to 0 just before it, read after
    counts, variants = {}, {}
    (counts["qwen1.5-0.5b"], variants["qwen1.5-0.5b"], qwen,
     qwen_params) = serve_full_width(device)
    gc.collect()
    torch.cuda.empty_cache()
    counts["qwen1.5-0.5b pooled"], variants["qwen1.5-0.5b pooled"] = \
        multitenant_full_width(qwen, qwen_params, device)
    del qwen, qwen_params
    for arch, batch, generate, steps in (("mamba2-780m", 8, 32, 8),
                                         ("zamba2-7b", 4, 16, 0)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counts[arch], variants[arch] = fixed_batch_full_width(
            arch, device, batch, 500, generate, profile_steps=steps)
    gc.collect()
    torch.cuda.empty_cache()
    total = {name: sum(c[name] for c in counts.values())
             for name in counts["qwen1.5-0.5b"]}
    emit({"phase": "launches", "per_path": counts,
          "kernel_variants_per_path": variants, "total": total})
    check(all(n > 0 for n in total.values()),
          f"a kernel never ran on the main paths: {total}")
    rows = kernel_times(device, total, errs)
    emit({"kernels": rows})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
