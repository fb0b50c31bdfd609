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

``--requests`` or ``--trace`` select the engine, which a family without
paged KV refuses (exit 2); otherwise the fixed-batch mode runs.  Prints
the JSON summary of ``repro.launch.serve``'s mode plus ``"device"``; the
engine mode exits 0 iff no request failed OOM.
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
from repro_torch.runtime import serve as serve_rt
from repro_torch.serve import (Engine, EngineConfig, latency_summary,
                               load_trace, run_trace, synthetic_trace)


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
    generator = torch.Generator(device=device).manual_seed(args.seed)
    engine = Engine.local(model, ecfg, generator=generator, budget=budget,
                          tracer=tracer, device=device)

    if args.trace:
        trace = load_trace(args.trace, vocab=cfg.vocab)
    else:
        trace = synthetic_trace(
            args.requests, mean_interarrival_s=args.interarrival,
            prompt_lens=tuple(int(x) for x in args.prompt_lens.split(",")),
            max_new_tokens=args.max_new, vocab=cfg.vocab, seed=args.seed)

    t0 = time.time()
    handles = run_trace(engine, trace)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    stats = engine.stats()
    out = {
        "arch": cfg.name, "mode": "engine", "lease": None,
        "device": str(device),
        "requests": len(handles),
        "latency": latency_summary(handles),
        "stats": stats,
        "wall_s": round(wall, 2),
        "sample_tokens": handles[0].tokens[:8] if handles else [],
    }
    if tracer is not None:
        engine.transport.quiesce()
        write_chrome_trace(tracer, args.trace_out)
        out["trace_out"] = {"path": args.trace_out, "events": len(tracer),
                            "dropped": tracer.dropped}
    emit_json(out)
    return 0 if stats["failed_oom"] == 0 else 1


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
