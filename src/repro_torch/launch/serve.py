"""Serving entry point of the port: the fixed-batch mode (every family) and
the request-level engine mode (the paged-KV families, dense and moe).

    # fixed batch (the default, as in ``repro.launch.serve``): prefill a
    # batch of random prompts, then greedy-decode, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --batch 8 --prompt 500 --generate 32

    # small config on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --batch 2 --prompt 16 --generate 4 --device cpu

    # synthetic request trace through the engine (dense and moe)
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

    # disaggregated: prefill tier + decode tier, KV streamed over the
    # routed fabric (direct pod-to-pod or staged through tier-2 memory)
    ... --requests 16 --disagg --disagg-staging tier2 --min-ready-pages 1

``--requests`` or ``--trace`` select the engine, which a family without
paged KV refuses (exit 2); otherwise the fixed-batch mode runs.  Prints
the JSON summary of ``repro.launch.serve``'s mode plus ``"device"``; the
engine modes (``--disagg`` too) exit 0 iff no request failed OOM.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import fabric as fb
from repro_torch.core.tiering import KVBudget
from repro_torch.device import resolve_device
from repro_torch.disagg import DisaggCluster, DisaggConfig, PrefillWorker
from repro_torch.fabric import Topology, Transport
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


def _budget(args):
    """The KV budget the flags ask for (None: unbudgeted tier-1, no
    tier-2)."""
    if not (args.tier1_pages or args.tier2_kv_gb):
        return None
    return KVBudget(tier1_pages=args.tier1_pages or None,
                    tier2_bytes=args.tier2_kv_gb * 1e9,
                    page_size=args.page_size)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _engine_mode(args, cfg, model, device) -> int:
    ecfg = EngineConfig(max_slots=args.slots, max_seq=args.max_seq,
                        page_size=args.page_size)
    tracer = Tracer(args.trace_capacity) if args.trace_out else None
    budget = _budget(args)

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


def _disagg_mode(args, cfg, model, device) -> int:
    """--disagg: prefill tier + decode tier on separate pods of one
    routed fabric, KV pages streamed between them (repro_torch.disagg).
    Every engine serves one set of weights, drawn once."""
    ecfg = EngineConfig(max_slots=args.slots, max_seq=args.max_seq,
                        page_size=args.page_size)
    tracer = Tracer(args.trace_capacity) if args.trace_out else None
    budget = _budget(args)

    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    n_pre, n_dec = args.prefill_pods, args.decode_pods
    workers = [PrefillWorker(Engine.local(model, ecfg, params=params,
                                          tracer=tracer, device=device),
                             name=f"p{i}")
               for i in range(n_pre)]
    dengines = [Engine.local(model, ecfg, params=params, budget=budget,
                             tracer=tracer, tenant=f"d{k}", device=device)
                for k in range(n_dec)]

    # a two-tier estate graph: every pod hangs off one leaf switch, the
    # staging memory node too; capacities default to ~50 page-transfers
    # per modeled second so handoffs are visible but not dominant
    pb = dengines[0].kv.page_bytes
    bw = args.kv_gbps * 1e9 if args.kv_gbps > 0 else 50.0 * pb
    lat = fb.tier2_memory_fabric(8).latency()
    topo = Topology("disagg-cli")
    topo.add_node("leaf", "switch")
    topo.add_node("mem:0", "memory")
    topo.connect("mem:0", "leaf", fb.CXL_CAPACITY, capacity=2.0 * bw,
                 latency=lat / 4)
    for i in range(n_pre + n_dec):
        topo.add_node(f"pod:{i}", "pod")
        topo.connect(f"pod:{i}", "leaf", fb.CXL3, capacity=bw,
                     latency=lat / 4)
    tx = Transport(topo, tracer=tracer)
    kw = dict(route=topo.route("pod:0", f"pod:{n_pre}"))
    if args.disagg_staging == "tier2":
        kw["stage_in"] = topo.route("pod:0", "mem:0")
        kw["stage_out"] = topo.route("mem:0", f"pod:{n_pre}")
    cluster = DisaggCluster(
        workers, dengines, transport=tx, tenant="cli",
        config=DisaggConfig(
            staging=args.disagg_staging,
            min_ready_pages=args.min_ready_pages or None,
            max_transit_s=args.max_transit_s or None), **kw)
    trace = _requests(args, cfg)

    t0 = time.time()
    handles = cluster.run(trace)
    _sync(device)
    wall = time.time() - t0
    failed = sum(e.stats()["failed_oom"] for e in dengines)
    transits = sorted(h.kv_transit_s for h in handles)
    out = {
        "arch": cfg.name, "mode": "disagg", "device": str(device),
        "staging": args.disagg_staging,
        "prefill_pods": n_pre, "decode_pods": n_dec,
        "requests": len(handles),
        "handoffs": cluster.handoffs, "colocated": cluster.colocated,
        "latency": latency_summary(handles),
        "kv_transit_s": {
            "mean": sum(transits) / max(1, len(transits)),
            "max": transits[-1] if transits else 0.0,
        },
        "wall_s": round(wall, 2),
        "sample_tokens": handles[0].tokens[:8] if handles else [],
    }
    if tracer is not None:
        out["trace_out"] = _flush_trace(
            tracer, [tx] + [e.transport for e in dengines]
            + [w.engine.transport for w in workers], args.trace_out)
    emit_json(out)
    return 0 if failed == 0 else 1


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
    ``model.load``), then ``batch`` prompts of ``prompt`` tokens, and for
    encdec ``batch`` x ``enc_seq`` bf16 frame embeddings (the stub
    frontend's output, as ``repro.launch.serve`` draws them).  Returns
    ``(raw, inputs)``, ``inputs`` the prefill's batch dict."""
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    raw = model.init(gen)
    inputs = {"tokens": torch.randint(1, cfg.vocab, (batch, prompt),
                                      generator=gen, device=device)}
    if cfg.family == "encdec":
        inputs["frame_embeds"] = torch.randn(
            batch, cfg.enc_seq, cfg.d_model, generator=gen,
            device=device).to(torch.bfloat16)
    return raw, inputs


def fixed_batch_generate(model, params, inputs, generate: int, device):
    """Prefill ``inputs`` (tokens (B, S), plus frame embeddings for
    encdec), then greedy-decode until ``generate`` tokens per row (the
    first from the prefill's logits) over an fp32 cache.  Returns
    ``tokens`` (B, generate) on the host, ``prefill_s``, ``decode_s``
    (the timed decode ends in ``torch.cuda.synchronize()`` on the card),
    ``decode_tokens_per_s``, the last ``carry`` and ``logits_finite`` over
    every step."""
    prefill = serve_rt.make_prefill_step(model)
    decode = serve_rt.make_decode_step(model)
    batch, prompt = inputs["tokens"].shape

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    cache = model.init_cache(batch, prompt + generate, dtype=torch.float32)
    t0 = time.perf_counter()
    logits, cache, *enc = prefill(params, inputs, cache)
    sync()
    t_prefill = time.perf_counter() - t0

    finite = torch.isfinite(logits).all()
    carry = {"tokens": torch.argmax(logits[:, -1:, :], dim=-1),
             "cache": cache, "index": prompt}
    if enc:
        carry["enc_states"] = enc[0]
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
    raw, inputs = fixed_batch_inputs(model, args.batch, args.prompt,
                                     args.seed, device)
    run = fixed_batch_generate(model, model.load(raw), inputs,
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
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated serving: prefill tier + decode "
                        "tier on separate pods, KV pages streamed over "
                        "the routed fabric (repro_torch.disagg)")
    p.add_argument("--disagg-staging", default="direct",
                   choices=["direct", "tier2"],
                   help="handoff path: direct pod-to-pod, or staged "
                        "through a tier-2 memory node (two priced legs)")
    p.add_argument("--prefill-pods", type=int, default=1)
    p.add_argument("--decode-pods", type=int, default=1)
    p.add_argument("--min-ready-pages", type=int, default=0,
                   help="admit a handed-off request once this many KV "
                        "pages landed (0 = wait for all)")
    p.add_argument("--max-transit-s", type=float, default=0.0,
                   help="route a request colocated when its predicted "
                        "KV transit exceeds this (0 = never)")
    p.add_argument("--kv-gbps", type=float, default=0.0,
                   help="fabric pod-uplink capacity for KV handoffs "
                        "(0 = auto-scale to ~50 pages/s)")
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
                 f"(dense/moe); {cfg.family!r} is not supported — use "
                 f"the fixed-batch mode (--batch/--prompt/--generate) "
                 f"instead")
            return 2
        if args.disagg:
            return _disagg_mode(args, cfg, model, device)
        return _engine_mode(args, cfg, model, device)
    return _legacy_batch_mode(args, cfg, model, device)


if __name__ == "__main__":
    raise SystemExit(main())
