"""chip_smoke.py's phase 13 alone on the card: the kernels built, one
card's references ((b)'s and (h)'s bf16 run, ``ts_one_card_run``; (f)'s
and (g)'s, ``ts_serve_refs``), 4 spawned ranks sharing the card on a
(data 1, model 4) world running ``chip_smoke.ts_rank`` on one torch
thread each (as ``tp_rank``), the parent's checks (``ts_checks``), then
phase 5's times.

    python3 chip_tools/phase13_alone.py
    # only (c), (f) and (g) in the ranks, and their checks
    python3 chip_tools/phase13_alone.py --fg
    # only (a), (b), (c) and (h) (the engine on (data 2, model 2)), and
    # their checks; of (f)'s references only dg_cut_runs'
    python3 chip_tools/phase13_alone.py --h
    # phase 12 (e) and phase 13 (c) and (i), olmoe-1b-7b expert parallel
    # on the world's (data 2, model 2) grid, and their checks
    python3 chip_tools/phase13_alone.py --moe
    # phase 12 (f) and phase 13 (c) and (j), mamba2-780m and zamba2-7b
    # under the ssm_* rules on the world's (data 2, model 2) grid, and
    # their checks
    python3 chip_tools/phase13_alone.py --ssm
    # phase 12 (g) and phase 13 (c) and (k), whisper-small (the encdec
    # family) on the world's (data 2, model 2) grid, and their checks
    python3 chip_tools/phase13_alone.py --encdec
"""
import collections, json, multiprocessing, shutil, sys, time
from pathlib import Path
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT)); sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs
OUT = ROOT / "build" / "phase13_alone"


def fg_rank(rank, refs):
    """(c), (f) and (g) of ``ts_rank``."""
    import torch
    device = torch.device("cuda", 0)
    out = {"kernels": cs.ts_kernels(device)}
    t0 = time.perf_counter()
    full, params = cs.ts_serve_model(device)
    out["disagg"] = cs.ts_disagg(rank, device, full, params, refs["disagg"])
    t1 = time.perf_counter()
    out["colo"] = cs.ts_colo(rank, device, params, refs["colo"])
    out["seconds_f_g"] = {"f": t1 - t0, "g": time.perf_counter() - t1}
    return out


def h_rank(rank, refs):
    """(a), (b), (c) and (h) of ``ts_rank``: (h) needs (a)'s one-card
    run, and its line prints (b)'s beside its own."""
    import torch
    device = torch.device("cuda", 0)
    out = {"fp32_gate": cs.ts_fp32_gate(rank, device),
           "full_depth": cs.ts_full_depth(device),
           "kernels": cs.ts_kernels(device)}
    full, params = cs.ts_serve_model(device)
    t0 = time.perf_counter()
    out["dp"] = cs.ts_dp(rank, device, out["fp32_gate"].get("one_card_run"),
                         full, params, refs["disagg"])
    out["seconds_f_g"] = {"h": time.perf_counter() - t0}
    return out


def moe_rank(rank, grid):
    """Phase 12 (e) on the world's (data 2, model 2) grid, then phase 13
    (c) and (i)."""
    import torch
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = {"ep": cs.ep_rank(grid)}
    t1 = time.perf_counter()
    out["kernels"] = cs.ts_kernels(device)
    out["moe"] = cs.ts_moe(rank, device)
    out["seconds_f_g"] = {"e": t1 - t0, "i": time.perf_counter() - t1}
    return out


def family_rank(rank, grid, mode):
    """Phase 12 (f) (``mode`` "ssm") or (g) ("encdec") on the world's
    (data 2, model 2) grid, then phase 13 (c) and (j) or (k)."""
    import torch
    device = torch.device("cuda", 0)
    train, serve, tags = {
        "ssm": (cs.SSM_TRAIN, cs.TS_SSM, ("(f)", "(j)")),
        "encdec": (cs.ENCDEC_TRAIN, cs.TS_ENCDEC, ("(g)", "(k)"))}[mode]
    prompt = (cs.TS_ENCDEC_PROMPT if mode == "encdec"
              else cs.TS_SESSION["prompt"])
    t0 = time.perf_counter()
    out = {mode: cs.family_rank(grid, train, tags[0])}
    t1 = time.perf_counter()
    out["kernels"] = cs.ts_kernels(device)
    out[f"serve_{mode}"] = cs.ts_fixed_batch(rank, device, serve, tags[1],
                                             prompt)
    out["seconds_f_g"] = {tags[0]: t1 - t0, tags[1]: time.perf_counter() - t1}
    return out


def rank_fn(rank, init, mode):
    import torch
    from repro_torch.launch import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    shape = (2, 2) if mode in ("moe", "ssm", "encdec") else (1, 4)
    grid = mesh_lib.init_grid(mesh_lib.Layout(shape, ("data", "model")),
                              rank=rank, device=torch.device("cuda", 0),
                              init_method=init, timeout_s=180)
    refs = json.loads((OUT / cs.TS_REFS).read_text())
    t0 = time.perf_counter()
    if mode == "moe":
        out = moe_rank(rank, grid)
    elif mode in ("ssm", "encdec"):
        out = family_rank(rank, grid, mode)
    else:
        out = {"fg": fg_rank, "h": h_rank}.get(mode, cs.ts_rank)(rank, refs)
    out["seconds"] = time.perf_counter() - t0
    grid.close()
    (OUT / f"rank{rank}.json").write_text(json.dumps(out))


def main():
    import torch
    from repro_torch.kernels import _build
    mode = ("fg" if "--fg" in sys.argv[1:] else
            "h" if "--h" in sys.argv[1:] else
            "moe" if "--moe" in sys.argv[1:] else
            "ssm" if "--ssm" in sys.argv[1:] else
            "encdec" if "--encdec" in sys.argv[1:] else "all")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    print("build", time.perf_counter() - t0, flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    family = mode in ("moe", "ssm", "encdec")
    qwen_run = None if family else cs.ts_one_card_run(dev)
    if family:
        refs = {}
    elif mode == "h":
        model, params = cs.ts_serve_model(dev)
        cut_ref, _, _ = cs.dg_cut_runs(model, params, dev)
        refs = json.loads(json.dumps({"disagg": {"fp32_cut": cut_ref}}))
        del model, params
    else:
        refs = cs.ts_serve_refs(dev)
    (OUT / cs.TS_REFS).write_text(json.dumps(refs))
    # (e)'s, (f)'s or (g)'s one-card bf16 trajectories
    mine = {"moe": [cs.EP_ARCH],
            "ssm": [a for a, *_ in cs.SSM_TRAIN],
            "encdec": [a for a, *_ in cs.ENCDEC_TRAIN]}.get(mode, [])
    one_card = {arch: cs.tp_reference_losses(dev, arch, layers, steps)
                for arch, layers, steps in cs.TP_ONE_CARD if arch in mine}
    print("one-card references", time.perf_counter() - t0, flush=True)
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_fn,
                         args=(r, f"file://{OUT}/store", mode))
             for r in range(4)]
    with cs.dp_allocator_env():
        for p in procs:
            p.start()
    secs = cs.wait_world(procs, 500, "phase 13 world")
    per = [json.loads((OUT / f"rank{r}.json").read_text()) for r in range(4)]
    cs.emit({"phase": "tp serve", "world_seconds": secs,
             "rank_seconds": [p["seconds"] for p in per],
             "seconds_f_g": [p["seconds_f_g"] for p in per]})
    if mode != "all":
        kern = [p["kernels"] for p in per]
        cs.emit({"phase": "tp serve", "check": "(c)", "per_rank": kern})
        cs.check(all(k["ok"] for ks in kern for k in ks.values()),
                 f"phase 13 (c): {kern}")
    if mode == "fg":
        counts = cs.ts_disagg_checks(smi, per, refs["disagg"])
        counts.update(cs.ts_colo_checks(smi, per, refs["colo"]))
    elif mode == "h":
        counts = cs.ts_dp_checks(smi, per, refs["disagg"], qwen_run)
    elif mode == "moe":
        layout = {"mesh": {"data": 2, "model": 2}}
        counts = cs.ep_checks(smi, [{"ep": p["ep"], "grids": {cs.EP_GRID: {
            "grid": layout}}} for p in per], one_card)
        counts.update(cs.ts_moe_checks(smi, per))
    elif mode in ("ssm", "encdec"):
        layout = {"mesh": {"data": 2, "model": 2}}
        train, serve = {"ssm": (cs.ssm_checks, cs.ts_ssm_checks),
                        "encdec": (cs.encdec_checks, cs.ts_encdec_checks)
                        }[mode]
        counts = train(smi, [{mode: p[mode], "grids": {
            cs.EP_GRID: {"grid": layout}}} for p in per], one_card)
        counts.update(serve(smi, [{mode: p[f"serve_{mode}"]} for p in per]))
    else:
        counts = cs.ts_checks(smi, per, qwen_run, refs)
    total = collections.defaultdict(int)
    for c in counts.values():
        for k, v in c.items():
            total[k] += v
    cs.kernel_times(torch.device("cuda"), total,
                    collections.defaultdict(float))
    print("phase13_alone ok", flush=True)


if __name__ == "__main__":
    main()
