"""Serving entry point of the port: the fixed-batch mode (every family the
port builds) and the request-level engine mode (paged-KV families).

    # fixed batch (the default, as in ``repro.launch.serve``): prefill a
    # batch of random prompts, then greedy-decode, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --batch 8 --prompt 500 --generate 32

    # small config on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --batch 2 --prompt 16 --generate 4 --device cpu

    # synthetic request trace through the engine (dense family only)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --requests 16 --max-new 64 --slots 8 --max-seq 1024 --page-size 64 \
        --tier1-pages 32 --tier2-kv-gb 4

    # trace file (JSONL: prompt_tokens / max_new_tokens / arrival_time)
    ... --trace /path/to/trace.jsonl

    # lease-backed: the pool grants the tier-2 KV budget
    ... --requests 16 --pool scalepool --pool-accels 4 --tier2-kv-gb 1

    # multi-tenant: N engines fair-sharing ONE physical page pool
    ... --requests 16 --tenants 3 --tier1-pages 24 --tier2-kv-gb 3
    # (+ --pool scalepool: the tenants share one lease's KV grant)

``--requests`` or ``--trace`` select the engine, which a family without
paged KV refuses (exit 2); otherwise the fixed-batch mode runs.  Prints
the JSON summary of ``repro.launch.serve``'s mode plus ``"device"``; the
engine modes exit 0 iff no request failed OOM.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.tiering import KVBudget
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.obs import Tracer, write_chrome_trace
from repro_torch.obs.console import emit_json, warn
from repro_torch.pool import smoke_pool
from repro_torch.runtime import serve as serve_rt
from repro_torch.serve import (Engine, EngineConfig, PoolArbiter,
                               latency_summary, load_trace, run_multi_trace,
                               run_trace, synthetic_trace)


def _flush_trace(tracer, transports, path: str) -> dict:
    """Drain every transport's in-flight transfers (their spans land at
    completion) and write the Perfetto-loadable trace file."""
    for tx in {id(t): t for t in transports if t is not None}.values():
        tx.quiesce()
    write_chrome_trace(tracer, path)
    return {"path": path, "events": len(tracer),
            "dropped": tracer.dropped}


def _requests(args, cfg):
    if args.trace:
        return load_trace(args.trace, vocab=cfg.vocab)
    return synthetic_trace(
        args.requests, mean_interarrival_s=args.interarrival,
        prompt_lens=tuple(int(x) for x in args.prompt_lens.split(",")),
        max_new_tokens=args.max_new, vocab=cfg.vocab, seed=args.seed)


def _lease(args, tenants=()):
    pool = smoke_pool(args.pool)
    return pool.lease("cli-serve", args.pool_accels,
                      tier2_gb=max(args.pool_tier2_gb, args.tier2_kv_gb),
                      kv_gb=args.tier2_kv_gb,
                      model_parallel=args.pool_model_parallel,
                      tenants=tenants)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _engine_mode(args, cfg, model, device) -> int:
    ecfg = EngineConfig(max_slots=args.slots, max_seq=args.max_seq,
                        page_size=args.page_size)
    tracer = Tracer(args.trace_capacity) if args.trace_out else None
    budget = None
    if args.tier1_pages or args.tier2_kv_gb:
        budget = KVBudget(
            tier1_pages=args.tier1_pages or None,
            tier2_bytes=args.tier2_kv_gb * 1e9,
            page_size=args.page_size)

    if args.tenants > 1:
        return _multitenant_mode(args, cfg, model, ecfg, device, tracer)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.pool != "none":
        engine = Engine.from_lease(model, _lease(args), ecfg,
                                   generator=generator, budget=budget,
                                   tracer=tracer, device=device)
    else:
        engine = Engine.local(model, ecfg, generator=generator,
                              budget=budget, tracer=tracer, device=device)
    trace = _requests(args, cfg)

    t0 = time.time()
    handles = run_trace(engine, trace)
    _sync(device)
    wall = time.time() - t0
    stats = engine.stats()
    out = {
        "arch": cfg.name, "mode": "engine",
        "lease": args.pool if args.pool != "none" else None,
        "device": str(device),
        "requests": len(handles),
        "latency": latency_summary(handles),
        "stats": stats,
        "wall_s": round(wall, 2),
        "sample_tokens": handles[0].tokens[:8] if handles else [],
    }
    if tracer is not None:
        out["trace_out"] = _flush_trace(tracer, [engine.transport],
                                        args.trace_out)
    emit_json(out)
    return 0 if stats["failed_oom"] == 0 else 1


def _multitenant_mode(args, cfg, model, ecfg, device, tracer=None) -> int:
    """--tenants N: N engines over ONE shared page pool (PoolArbiter),
    traffic (synthetic or --trace JSONL) split round-robin across
    tenants.  The tenants serve one set of weights, drawn once."""
    if args.pool != "none" and args.tier2_kv_gb <= 0:
        warn("--tenants with --pool shares one KV grant across the "
             "tenants — pass --tier2-kv-gb > 0 so the lease has kv "
             "bytes to share")
        return 2

    names = [f"t{i}" for i in range(args.tenants)]
    tier1 = args.tier1_pages or args.tenants * args.slots * ecfg.pages_per_slot
    arb = PoolArbiter(tier1, page_size=args.page_size, tracer=tracer)
    per_tenant = KVBudget(tier2_bytes=args.tier2_kv_gb * 1e9 / args.tenants,
                          page_size=args.page_size)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    if args.pool != "none":
        lease = _lease(args, tenants=tuple(names))
        engines = {n: Engine.from_lease(model, lease, ecfg, params=params,
                                        arbiter=arb, tenant=n,
                                        tracer=tracer, device=device)
                   for n in names}
    else:
        engines = {n: Engine.local(model, ecfg, params=params,
                                   budget=per_tenant, arbiter=arb,
                                   tenant=n, tracer=tracer, device=device)
                   for n in names}

    trace = _requests(args, cfg)
    split = {n: [r for j, r in enumerate(trace)
                 if j % args.tenants == i]
             for i, n in enumerate(names)}

    t0 = time.time()
    results = run_multi_trace([(engines[n], split[n]) for n in names])
    _sync(device)
    wall = time.time() - t0
    out = {"arch": cfg.name, "mode": "multitenant", "device": str(device),
           "tenants": args.tenants, "tier1_pages": tier1,
           "wall_s": round(wall, 2), "arbiter": arb.stats(), "per_tenant": {}}
    failed = 0
    for n, handles in zip(names, results):
        st = engines[n].stats()
        failed += st["failed_oom"]
        out["per_tenant"][n] = {
            "requests": len(handles),
            "latency": latency_summary(handles),
            "swaps": st["preempt_swaps"],
            "recomputes": st["preempt_recomputes"],
            "tput_busy_tok_s": st["throughput_busy_tok_s"],
        }
    if tracer is not None:
        out["trace_out"] = _flush_trace(
            tracer, [e.transport for e in engines.values()],
            args.trace_out)
    emit_json(out)
    return 0 if failed == 0 else 1


def fixed_batch_inputs(model, batch: int, prompt: int, seed: int, device):
    """The fixed-batch mode's draw from one ``torch.Generator`` seeded by
    ``seed``: random weights as drawn (the config's param dtype, before
    ``model.load``), then ``batch`` prompts of ``prompt`` tokens."""
    gen = torch.Generator(device=device).manual_seed(seed)
    raw = model.init(gen)
    prompts = torch.randint(1, model.cfg.vocab, (batch, prompt),
                            generator=gen, device=device)
    return raw, prompts


def fixed_batch_generate(model, params, prompts, generate: int, device):
    """Prefill ``prompts`` (B, S), then greedy-decode until ``generate``
    tokens per row (the first from the prefill's logits) over an fp32
    cache.  Returns ``tokens`` (B, generate) on the host, ``prefill_s``,
    ``decode_s`` (the timed decode ends in ``torch.cuda.synchronize()``
    on the card), ``decode_tokens_per_s``, the last ``carry`` and
    ``logits_finite`` over every step."""
    prefill = serve_rt.make_prefill_step(model)
    decode = serve_rt.make_decode_step(model)
    batch, prompt = prompts.shape

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    cache = model.init_cache(batch, prompt + generate, dtype=torch.float32)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts}, cache)
    sync()
    t_prefill = time.perf_counter() - t0

    finite = torch.isfinite(logits).all()
    carry = {"tokens": torch.argmax(logits[:, -1:, :], dim=-1),
             "cache": cache, "index": prompt}
    generated = [carry["tokens"]]
    t0 = time.perf_counter()
    for _ in range(generate - 1):
        logits, carry = decode(params, carry)
        generated.append(carry["tokens"])
        finite &= torch.isfinite(logits).all()
    sync()
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(generated, dim=1).cpu(),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_tokens_per_s": batch * (generate - 1) / max(t_decode,
                                                                1e-9),
            "carry": carry, "logits_finite": bool(finite)}


def _legacy_batch_mode(args, cfg, model, device) -> int:
    raw, prompts = fixed_batch_inputs(model, args.batch, args.prompt,
                                      args.seed, device)
    run = fixed_batch_generate(model, model.load(raw), prompts,
                               args.generate, device)
    toks = run["tokens"]
    emit_json({
        "arch": cfg.name, "mode": "batch", "device": str(device),
        "batch": args.batch, "prompt": args.prompt,
        "generated": toks.shape[1],
        "prefill_s": round(run["prefill_s"], 3),
        "decode_tok_per_s": round(run["decode_tokens_per_s"], 1),
        "sample_tokens": toks[0, :8].tolist(),
    })
    return 0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen1.5-0.5b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' must be asked "
                        "for by name)")
    p.add_argument("--requests", type=int, default=0,
                   help="serve N synthetic requests through the engine")
    p.add_argument("--trace", default=None,
                   help="JSONL request trace driven through the engine")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=256)
    p.add_argument("--page-size", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--prompt-lens", default="16,32,64")
    p.add_argument("--interarrival", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the trace or prompts and the random weights")
    p.add_argument("--tier1-pages", type=int, default=0,
                   help="tier-1 KV page quota (0 = full slot capacity)")
    p.add_argument("--tier2-kv-gb", type=float, default=0.0,
                   help="tier-2 KV byte budget (spill target)")
    p.add_argument("--tenants", type=int, default=1,
                   help="N>1: N tenant engines over ONE shared page pool "
                        "(PoolArbiter fair shares), traffic split "
                        "round-robin")
    p.add_argument("--pool", default="none",
                   choices=["none", "scalepool", "baseline"],
                   help="take the engine's KV budget from a lease on a "
                        "smoke estate of this interconnect")
    p.add_argument("--pool-accels", type=int, default=4)
    p.add_argument("--pool-tier2-gb", type=float, default=0.0)
    p.add_argument("--pool-model-parallel", type=int, default=1)
    p.add_argument("--trace-out", default=None,
                   help="write a Chrome/Perfetto trace_event JSON of the "
                        "run's modeled timeline")
    p.add_argument("--trace-capacity", type=int, default=1 << 16,
                   help="flight-recorder ring size (events)")
    # fixed-batch mode
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt", type=int, default=64)
    p.add_argument("--generate", type=int, default=32)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=device)
    if args.requests or args.trace:
        if not model.supports_paged_kv:
            warn(f"the request-level engine serves paged-KV families "
                 f"(dense); {cfg.family!r} is not supported — use the "
                 f"fixed-batch mode (--batch/--prompt/--generate) instead")
            return 2
        return _engine_mode(args, cfg, model, device)
    return _legacy_batch_mode(args, cfg, model, device)


if __name__ == "__main__":
    raise SystemExit(main())
