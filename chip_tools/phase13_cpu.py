"""Rehearse chip_smoke.py's phase 13 (d)-(h) on the CPU, before a chip
call.

    # the rank code of (d)-(h) in 4 spawned CPU ranks over gloo, at smoke
    # width (the configs' ``smoke=True``): the session's fp32 gate
    # against one process, its bf16 run on both grids, the two tenants,
    # the disaggregated tiers, the co-resident tenants and (h)'s engine
    # on (data 2, model 2) (with (a) and (b), whose runs (h) is held to
    # and printed beside) held by the smoke's own checks (launch counts
    # aside: the CPU launches no kernel) to one process's references
    # (``ts_serve_refs``, ``ts_one_card_run``); (h)'s seconds a rank.
    # At smoke width the modeled costs price the smoke config, so phase
    # 4's trace never fills the quota: (h)'s spill checks fail here, as
    # fig12's p95 and fig11's contention claims do
    PYTHONPATH=src python chip_tools/phase13_cpu.py
    # (e)'s schedule at full width on its first 2 layers, one process,
    # under each tier-1 pool size given: revoked pages, revocations,
    # recompute drops, completed requests (tokens do not move the
    # schedule, so the card's run revokes the same pages)
    PYTHONPATH=src python chip_tools/phase13_cpu.py --pages 24 32 40
    # (f)'s and (g)'s one-card runs at full width on their first 2
    # layers, one process: each run's engine steps, decode steps and
    # prefills (the full depth's too: tokens do not move the schedule),
    # handoffs, fig12's and fig11's modeled numbers, and the seconds
    PYTHONPATH=src python chip_tools/phase13_cpu.py --serve-counts
    # phase 12 (e) and 13 (i), the moe family across the ranks of a
    # (data 2, model 2) grid, at smoke width in 4 CPU ranks: (e)'s fp32
    # gate of tp and tp_fsdp against one process and its bf16 steps
    # against one process's, (i)'s engine in fp32 against one process
    # and in bf16, through the smoke's own checks (each failure printed;
    # the launch counts fail here, the CPU launches no kernel, and so
    # does (i)'s spill check: phase 4's trace does not spill at smoke
    # width); the collectives a rank made and its seconds
    PYTHONPATH=src python chip_tools/phase13_cpu.py --moe
    # phase 12 (f) and 13 (j), the ssm and hybrid families under the
    # ssm_* rules on a (data 2, model 2) grid, at smoke width in 4 CPU
    # ranks: (f)'s fp32 gates against one process and bf16 steps against
    # one process's, (j)'s fp32 session against one process and its bf16
    # run, through the smoke's own checks (each failure printed; the
    # launch counts and kernel variants fail here, the CPU launches no
    # kernel); the collectives a rank made and its seconds
    PYTHONPATH=src python chip_tools/phase13_cpu.py --ssm
    # phase 12 (g) and 13 (k), the encdec family (whisper-small) on a
    # (data 2, model 2) grid, likewise
    PYTHONPATH=src python chip_tools/phase13_cpu.py --encdec

Each rank runs one torch thread; ~60 s for the first, ~30 s a pool size
for the second, ~60 s for the third.
"""
import argparse
import dataclasses
import json
import multiprocessing
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "phase13_cpu"


def smoke_width():
    """chip_smoke at smoke width on the CPU: every config ``smoke=True``,
    the card's synchronizing and memory calls no-ops; returns it."""
    import torch
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    import repro_torch.configs as configs
    full = configs.get_config
    configs.get_config = lambda name, smoke=False: full(name, smoke=True)
    import chip_smoke as cs
    cs.cut = lambda arch, n, **kw: dataclasses.replace(
        full(arch, smoke=True), n_layers=n, **kw)
    # ts_serve_model cuts the smoke config, which has only 2 layers
    cs.SERVE_DEPTH = cs.TP_DEPTH = full("qwen1.5-0.5b", smoke=True).n_layers
    return cs


def rank_fn(rank, init):
    import torch
    torch.set_num_threads(1)
    cs = smoke_width()
    from repro_torch.launch import mesh as mesh_lib
    grid = mesh_lib.init_grid(mesh_lib.Layout((1, 4), ("data", "model")),
                              rank=rank, device=torch.device("cpu"),
                              init_method=init, timeout_s=120)
    cpu = torch.device("cpu")
    out = {"session_gate": cs.ts_session_gate(rank, cpu),
           "session_full": cs.ts_session_full(cpu),
           "tenants": cs.ts_tenants(rank, cpu)}
    refs = json.loads((OUT / cs.TS_REFS).read_text())
    full, params = cs.ts_serve_model(cpu)
    out["disagg"] = cs.ts_disagg(rank, cpu, full, params, refs["disagg"])
    out["colo"] = cs.ts_colo(rank, cpu, params, refs["colo"])
    out["fp32_gate"] = cs.ts_fp32_gate(rank, cpu)
    out["full_depth"] = cs.ts_full_depth(cpu)
    t0 = time.perf_counter()
    out["dp"] = cs.ts_dp(rank, cpu, out["fp32_gate"].get("one_card_run"),
                         full, params, refs["disagg"])
    out["seconds_h"] = time.perf_counter() - t0
    grid.close()
    (OUT / f"rank{rank}.json").write_text(json.dumps(out))


def rehearse():
    import torch
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    torch.set_num_threads(1)
    cs = smoke_width()
    refs = cs.ts_serve_refs(torch.device("cpu"))
    (OUT / cs.TS_REFS).write_text(json.dumps(refs))
    qwen_run = cs.ts_one_card_run(torch.device("cpu"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_fn, args=(r, f"file://{OUT}/store"))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    codes = [p.exitcode for p in procs]
    if any(codes):
        print(f"rank exit codes {codes}")
        return 1
    per = [json.loads((OUT / f"rank{r}.json").read_text()) for r in range(4)]
    r0 = per[0]
    for name, g in r0["session_gate"].items():
        print("(d) fp32 gate", name, g.get("one_card"),
              "ranks agree:", all(p["session_gate"][name]["tokens"]
                                  == g["tokens"] for p in per))
    for name, f in r0["session_full"].items():
        print("(d) full", name, f["rows"], f["collective_calls"],
              "ranks agree:", all(p["session_full"][name]["tokens"]
                                  == f["tokens"] for p in per))
    t = r0["tenants"]
    print("(e)", {k: t[k] for k in ("arbiter", "one_card", "decodes",
                                    "prefills", "sanitizer")},
          "ranks agree:", all(p["tenants"]["tokens"] == t["tokens"]
                              and p["tenants"]["clocks"] == t["clocks"]
                              for p in per))
    # (f) and (g) through the smoke's checks, but the launch counts;
    # each failed check printed (at smoke width fig12's decode p95 claim
    # and fig11's contention_dominates fail: the modeled costs price the
    # smoke config here, not the full qwen1.5-0.5b)
    failed = []
    cs.ts_launch_checks = lambda *a, **k: None
    cs.check = lambda cond, msg: cond or failed.append(msg)
    cs.emit = lambda obj: print(json.dumps(obj)[:1500])
    cs.ts_disagg_checks("cpu", per, refs["disagg"])
    cs.ts_colo_checks("cpu", per, refs["colo"])
    for msg in failed:
        print("FAILED:", msg[:600])
    print(f"(f), (g): {len(failed)} checks failed")
    failed.clear()
    cs.ts_dp_checks("cpu", per, refs["disagg"], qwen_run)
    for msg in failed:
        print("FAILED:", msg[:600])
    print(f"(h): {len(failed)} checks failed; seconds a rank "
          f"{[round(p['seconds_h'], 1) for p in per]}")
    return 0


def moe_rank_fn(rank, init):
    import torch
    torch.set_num_threads(1)
    cs = smoke_width()
    from repro_torch.launch import mesh as mesh_lib
    grid = mesh_lib.init_grid(mesh_lib.Layout((2, 2), ("data", "model")),
                              rank=rank, device=torch.device("cpu"),
                              init_method=init, timeout_s=120)
    t0 = time.perf_counter()
    out = {"ep": cs.ep_rank(grid)}
    t1 = time.perf_counter()
    out["moe"] = cs.ts_moe(rank, torch.device("cpu"))
    out["seconds"] = {"e": t1 - t0, "i": time.perf_counter() - t1}
    grid.close()
    (OUT / f"moe_rank{rank}.json").write_text(json.dumps(out))


def moe():
    """Phase 12 (e) and 13 (i) at smoke width in 4 CPU ranks, through
    the smoke's checks."""
    import torch
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "moe_store").unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=moe_rank_fn,
                         args=(r, f"file://{OUT}/moe_store"))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    codes = [p.exitcode for p in procs]
    if any(codes):
        print(f"rank exit codes {codes}")
        return 1
    torch.set_num_threads(1)
    cs = smoke_width()
    per = [json.loads((OUT / f"moe_rank{r}.json").read_text())
           for r in range(4)]
    failed = []
    cs.check = lambda cond, msg: cond or failed.append(msg)
    cs.emit = lambda obj: print(json.dumps(obj)[:1500])
    layout = {"mesh": {"data": 2, "model": 2}}
    cs.ep_checks("cpu", [{"ep": p["ep"], "grids": {cs.EP_GRID: {
        "grid": layout}}} for p in per], {cs.EP_ARCH: cs.tp_reference_losses(
            torch.device("cpu"), cs.EP_ARCH, cs.EP_DEPTH, cs.EP_STEPS)})
    cs.ts_moe_checks("cpu", per)
    for msg in failed:
        print("FAILED:", msg[:600])
    print(f"(e), (i): {len(failed)} checks failed; seconds a rank "
          f"{[p['seconds'] for p in per]}; (i) collectives on rank 0 "
          f"{per[0]['moe']['bfloat16']['collective_calls']}")
    return 0


def family_parts(cs, mode):
    """(training entries, serving entries, tags, prompt) of ``mode``."""
    if mode == "encdec":
        return (cs.ENCDEC_TRAIN, cs.TS_ENCDEC, ("(g)", "(k)"),
                cs.TS_ENCDEC_PROMPT)
    return cs.SSM_TRAIN, cs.TS_SSM, ("(f)", "(j)"), cs.TS_SESSION["prompt"]


def family_rank_fn(rank, init, mode):
    import torch
    torch.set_num_threads(1)
    cs = smoke_width()
    from repro_torch.launch import mesh as mesh_lib
    grid = mesh_lib.init_grid(mesh_lib.Layout((2, 2), ("data", "model")),
                              rank=rank, device=torch.device("cpu"),
                              init_method=init, timeout_s=120)
    train, serve, tags, prompt = family_parts(cs, mode)
    t0 = time.perf_counter()
    out = {mode: cs.family_rank(grid, train, tags[0])}
    t1 = time.perf_counter()
    out[f"serve_{mode}"] = cs.ts_fixed_batch(rank, torch.device("cpu"),
                                             serve, tags[1], prompt)
    out["seconds"] = {tags[0]: t1 - t0, tags[1]: time.perf_counter() - t1}
    grid.close()
    (OUT / f"{mode}_rank{rank}.json").write_text(json.dumps(out))


def family(mode):
    """Phase 12 (f) and 13 (j) (``mode`` "ssm"), or (g) and (k)
    ("encdec"), at smoke width in 4 CPU ranks, through the smoke's
    checks."""
    import torch
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{mode}_store").unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=family_rank_fn,
                         args=(r, f"file://{OUT}/{mode}_store", mode))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(900)
    codes = [p.exitcode for p in procs]
    if any(codes):
        print(f"rank exit codes {codes}")
        return 1
    torch.set_num_threads(1)
    cs = smoke_width()
    per = [json.loads((OUT / f"{mode}_rank{r}.json").read_text())
           for r in range(4)]
    failed = []
    cs.check = lambda cond, msg: cond or failed.append(msg)
    cs.emit = lambda obj: print(json.dumps(obj)[:1500])
    layout = {"mesh": {"data": 2, "model": 2}}
    train, serve, tags, _ = family_parts(cs, mode)
    mine = [a for a, *_ in train]
    checks = {"ssm": (cs.ssm_checks, cs.ts_ssm_checks),
              "encdec": (cs.encdec_checks, cs.ts_encdec_checks)}[mode]
    checks[0]("cpu", [{mode: p[mode], "grids": {cs.EP_GRID: {
        "grid": layout}}} for p in per], {
            arch: cs.tp_reference_losses(torch.device("cpu"), arch, layers,
                                         steps)
            for arch, layers, steps in cs.TP_ONE_CARD if arch in mine})
    checks[1]("cpu", [{mode: p[f"serve_{mode}"]} for p in per])
    for msg in failed:
        print("FAILED:", msg[:600])
    print(f"{tags}: {len(failed)} checks failed; seconds a rank "
          f"{[p['seconds'] for p in per]}; {tags[1]} collectives on rank 0 "
          f"{per[0][f'serve_{mode}'][serve[0][0]]['full']['collective_calls']}")
    return 0


def serve_counts():
    import torch
    torch.set_num_threads(4)
    import chip_smoke as cs
    from repro_torch.models.api import build_model
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    full = build_model(cs.cut("qwen1.5-0.5b", cs.TRAIN_CUT), device=cpu)
    params = full.load(full.init(torch.Generator().manual_seed(0)))
    tracers = []
    ref, m32, p32 = cs.dg_cut_runs(full, params, cpu, tracers=tracers)
    for name, trs in (("colocated", tracers[:1]), ("direct", tracers[1:2]),
                      ("degenerate", tracers[2:])):
        names = [e.name for t in trs for e in t.events()]
        print(json.dumps({"run": f"(f) {name}",
                          "decodes": names.count("decode"),
                          "prefills": names.count("prefill")}))
    print(json.dumps({"(f) modeled": ref["modeled"], "wall_s": ref["wall_s"],
                      "seconds": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    tracers = []
    runs, walls, page = cs.co_three(m32, p32, cpu, cs.CO_REQUESTS,
                                    cs.CO_STEPS, tracers=tracers)
    for (name, _, _), t in zip(cs.CO_RUNS, tracers):
        names = [e.name for e in t.events()]
        print(json.dumps({"run": f"(g) {name}",
                          "engine_steps": sum(e.steps for e in
                                              runs[name]["engines"].values()),
                          "decodes": names.count("decode"),
                          "prefills": names.count("prefill"),
                          "wall_s": walls[name]}))
    print(json.dumps({"(g) claims": cs.co_claims(runs),
                      "agg_p95_s": {k: r["agg_p95"] for k, r in runs.items()},
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def quota(pages_list):
    import torch
    torch.set_num_threads(4)
    import chip_smoke as cs
    from repro_torch.models.api import build_model
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import Engine, PoolArbiter, run_multi_trace
    cfg = cs.cut("qwen1.5-0.5b", cs.TRAIN_CUT, compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ecfg, trace = cs.ts_tenant_parts(cfg)
    lease = smoke_pool("scalepool").lease(
        "serve-tenants", cs.TS_MODEL, tier2_gb=8, kv_gb=4,
        tenants=cs.TS_MT_TENANTS)
    n = len(cs.TS_MT_TENANTS)
    for pages in pages_list:
        t0 = time.perf_counter()
        arb = PoolArbiter(pages, page_size=ecfg.page_size)
        engines = [Engine.local(model, ecfg, params=params, arbiter=arb,
                                tenant=t, device="cpu",
                                budget=lease.kv_share(
                                    t, page_size=ecfg.page_size))
                   for t in cs.TS_MT_TENANTS]
        run_multi_trace([(e, trace[i::n]) for i, e in enumerate(engines)])
        print(json.dumps({"pages": pages,
                          "revoked_pages": arb.revoked_pages,
                          "revocations": arb.revocations,
                          "recompute_drops": arb.recompute_drops,
                          "completed": [e.stats()["completed"]
                                        for e in engines],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pages", type=int, nargs="*")
    p.add_argument("--serve-counts", action="store_true")
    p.add_argument("--moe", action="store_true")
    p.add_argument("--ssm", action="store_true")
    p.add_argument("--encdec", action="store_true")
    args = p.parse_args()
    if args.serve_counts:
        return serve_counts()
    if args.moe:
        return moe()
    if args.ssm or args.encdec:
        return family("ssm" if args.ssm else "encdec")
    return quota(args.pages) if args.pages else rehearse()


if __name__ == "__main__":
    raise SystemExit(main())
