"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root, one GPU

Phases, each printing one JSON line; any failure raises (nonzero exit,
no result line):

1. device   - the card's name and power limit, TF32 off;
2. build    - the CUDA kernels of ``src/repro_torch/csrc`` compiled by
              nvcc, with the build time;
3. kernels  - each kernel against its plain PyTorch version on the card
              at the serving path's shapes, max errors beside their
              tolerances, and bitwise page-layout invariance;
4. serve    - qwen1.5-0.5b at full width (24 layers, d=1024, vocab
              151,936, seeded random weights) served by
              ``repro_torch.serve.Engine`` through ``run_trace``: 16
              requests under a 32-page tier-1 quota with a 4 GB tier-2
              budget, so sequences pause, spill and fetch.  Every kernel
              launch of the run is counted, and one prefill's and one
              decode step's logits are held against the plain path
              (gated with the weights upcast to fp32 compute; the
              served bf16 comparison is reported beside it);
5. times    - each kernel's time (CUDA graphs of back-to-back calls,
              timed with CUDA events, median of trials) beside its plain
              version, a PyTorch library call where one computes the
              same function, and the bound from the H100's published
              peaks;
6. the contract line ``{"ok": true, "device": {...}}``, last.

It imports torch, numpy and ``repro_torch`` only (no JAX).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
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


def kernel_checks(device):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

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

    # flash: the prefill's shape, bf16 q against the fp32 cache
    for Sq in (64, 130, 512):
        q = torch.randn(1, Sq, 16, 64, generator=gen, device=device).to(bf16)
        k = torch.randn(1, Sq, 16, 64, generator=gen, device=device)
        v = torch.randn(1, Sq, 16, 64, generator=gen, device=device)
        got = flash_attention(q, k, v, causal=True)
        want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2)).transpose(1, 2)
        errs["flash_attention"] = record(
            "flash_attention", f"B=1 Sq=Skv={Sq} H=16 D=64 q=bf16 kv=fp32",
            got, want, TOL["bfloat16"])
    q = torch.randn(2, 70, 8, 128, generator=gen, device=device)
    k = torch.randn(2, 96, 2, 128, generator=gen, device=device)
    v = torch.randn(2, 96, 2, 128, generator=gen, device=device)
    record("flash_attention", "GQA G=4 D=128 window=24 q_offset=10 kv_len=80",
           flash_attention(q, k, v, causal=True, sliding_window=24,
                           q_offset=10, kv_len=80),
           ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), sliding_window=24,
                             q_offset=10, kv_len=80).transpose(1, 2),
           TOL["float32"])

    # rmsnorm: the model's rows and widths, bf16 activations and scale
    for rows in (1, 7, 300):
        for d in (64, 1024):
            x = torch.randn(rows, d, generator=gen, device=device).to(bf16)
            s = (1 + 0.1 * torch.randn(d, generator=gen, device=device)
                 ).to(bf16)
            e = record("rmsnorm", f"rows={rows} d={d} bf16", rmsnorm(x, s),
                       ref.rmsnorm_ref(x, s), TOL["bfloat16"])
            if (rows, d) == (300, 1024):
                errs["rmsnorm"] = e
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
          "launches": counts, "latency_modeled": latency_summary(handles),
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
    check(counts["rmsnorm"] == (decodes + prefills) * (2 * L + 1),
          f"rmsnorm launches {counts['rmsnorm']} != "
          f"{decodes + prefills} calls x {2 * L + 1}")
    # the served bf16 path, kernels vs plain: reported, not gated — bf16
    # rounding flips compound over 24 random-weight layers (phase 3
    # gates each kernel at these shapes in bf16)
    logits_check(model, engine.params, trace[0].prompt_tokens, device,
                 gate=False)
    # the same weights, upcast exactly, computed in fp32: gated
    model32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                          device=device)
    logits_check(model32, model32.load(engine.params),
                 trace[0].prompt_tokens, device, gate=True)
    del model32
    profile_window(model, engine.params, device)
    return counts, stats, wall


def profile_window(model, params, device):
    """Where the serving time goes: 8 requests of 250 prompt tokens and
    32 new tokens arriving at once, on the same model and engine shape
    without a quota, run twice plain (the second timed) and once under
    ``torch.profiler``.  The device's busy share is the profiled
    kernel and copy time over the plain run's wall time.  Reported, not
    gated."""
    import torch
    from torch.autograd import DeviceType
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
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile", "requests": 8, "engine_steps": steps,
          "wall_s": wall, "profiled_wall_s": profiled_wall,
          "device_busy_s": busy_s if by_name else None,
          "device_busy_share": busy_s / wall if by_name else None,
          "top_device_time": [{"name": k[:90], "ms": t / 1e3, "calls": n}
                              for k, (t, n) in top]})


def logits_check(model, params, prompt, device, gate: bool):
    """One prefill and one decode step of the served model through the
    kernels and through the plain versions, on the same inputs; with
    ``gate`` a mismatch beyond the bf16 tolerance fails the run."""
    import torch
    from repro_torch.kernels import ops

    cfg = model.cfg
    plen, ps = len(prompt), 64
    bucket = -(-plen // ps) * ps
    tokens = torch.zeros((1, bucket), dtype=torch.long, device=device)
    tokens[0, :plen] = torch.as_tensor(prompt, device=device)

    def prefill():
        cache = model.init_cache(1, bucket, dtype=torch.float32)
        return model.prefill_at(params, {"tokens": tokens}, cache, plen - 1)

    got, cache = prefill()
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
    got, _ = model.decode_paged(params, tok, {n: p.clone()
                                              for n, p in pools.items()},
                                table, lengths)
    with ops.plain_versions():
        want, _ = model.decode_paged(params, tok, pools, table, lengths)
    report("decode", got, want, model.cfg.compute_dtype, gate)


def report(step, got, want, compute, gate):
    import torch
    torch.cuda.synchronize()
    e = max_err(got, want)
    ok = within(got, want, TOL["bfloat16"]) and bool(
        torch.isfinite(got).all())
    same_top = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    emit({"phase": "serve", "check": f"{step} logits, kernels vs plain",
          "compute": compute, "shape": list(got.shape), "max_abs_err": e,
          "logit_absmax": float(want.float().abs().max()),
          "same_argmax": same_top, "tol": TOL["bfloat16"], "gated": gate,
          "ok": ok})
    if gate:
        check(ok, f"{step} logits ({compute}): kernels vs plain max err {e}")


# ---------------------------------------------------------------------------
# phase 5: times at the serving path's shapes
# ---------------------------------------------------------------------------

def kernel_times(device, counts, errs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=device).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def row(mod, name, ms, plain_ms, bound_ms, bound_by, library_ms):
        rows.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                     "replaces": mod.REPLACES, "launches": counts[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})

    # paged: a full decode batch (8 rows, 120..563 live tokens, the trace's
    # prompt lengths plus generated tokens), four copies of the pool so
    # the timed calls read cold K/V as a decode step does layer by layer
    lens = [130, 260, 520, 150, 300, 563, 200, 400]
    sets = [paged_inputs(gen, 8, 16, 16, 64, 64, 16, lens, bf16, f32, device)
            for _ in range(4)]
    ms = time_ms(lambda i: pa.paged_decode_attention(*sets[i]), 4)
    plain = time_ms(lambda i: ref.paged_attention_ref(*sets[i]), 4)
    live = sum(lens)
    q, kp = sets[0][0], sets[0][1]
    nbytes = (2 * live * 16 * 64 * kp.element_size()          # K and V
              + 2 * q.numel() * q.element_size()              # q, out
              + 4 * sum(-(-n // 64) for n in lens) + 4 * 8)   # table, lens
    b_ms, b_by = bound(nbytes, 4 * live * 16 * 64, BF16_FLOPS)
    row(pa, "paged_attention", ms, plain, b_ms, b_by, None)

    # flash: the largest prefill bucket of the trace (512), bf16 q, fp32
    # cache
    S, H, D = 512, 16, 64
    q = torch.randn(1, S, H, D, generator=gen, device=device).to(bf16)
    k = torch.randn(1, S, H, D, generator=gen, device=device)
    v = torch.randn(1, S, H, D, generator=gen, device=device)
    ms = time_ms(lambda i: fa.flash_attention(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    plain = time_ms(lambda i: ref.attention_ref(qt, kt, vt, causal=True))
    q32 = qt.float()
    lib = time_ms(lambda i: F.scaled_dot_product_attention(
        q32, kt, vt, is_causal=True, enable_gqa=True))
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * 4
    flops = 4 * D * H * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    row(fa, "flash_attention", ms, plain, b_ms, b_by, lib)

    # rmsnorm: a prefill bucket's rows at d_model, bf16 (the input was
    # just written by the previous op, so it is timed warm)
    x = torch.randn(512, 1024, generator=gen, device=device).to(bf16)
    s = (1 + 0.1 * torch.randn(1024, generator=gen, device=device)).to(bf16)
    ms = time_ms(lambda i: rn.rmsnorm(x, s))
    plain = time_ms(lambda i: ref.rmsnorm_ref(x, s))
    lib = (time_ms(lambda i: F.rms_norm(x, (1024,), weight=s, eps=1e-6))
           if hasattr(F, "rms_norm") else None)
    b_ms, b_by = bound(2 * x.numel() * 2 + s.numel() * 2, 4 * x.numel(),
                       BF16_FLOPS)
    row(rn, "rmsnorm", ms, plain, b_ms, b_by, lib)
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
    log = (lib.parent / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(line, file=sys.stderr)

    errs = kernel_checks(device)
    counts, stats, wall = serve_full_width(device)
    rows = kernel_times(device, counts, errs)
    emit({"kernels": rows})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
