"""chip_smoke.py's phase 13 alone on the card: the kernels built, (f)'s
and (g)'s one-card references (``ts_serve_refs``), 4 spawned ranks
sharing the card on a (data 1, model 4) world running
``chip_smoke.ts_rank`` on one torch thread each (as ``tp_rank``), the
parent's checks (``ts_checks``, phase 13 (b)'s tokens standing in for
phase 4's), then phase 5's times.

    python3 chip_tools/phase13_alone.py
    # only (c), (f) and (g) in the ranks, and their checks
    python3 chip_tools/phase13_alone.py --fg
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


def rank_fn(rank, init, fg):
    import torch
    from repro_torch.launch import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    grid = mesh_lib.init_grid(mesh_lib.Layout((1, 4), ("data", "model")),
                              rank=rank, device=torch.device("cuda", 0),
                              init_method=init, timeout_s=180)
    refs = json.loads((OUT / cs.TS_REFS).read_text())
    t0 = time.perf_counter()
    out = fg_rank(rank, refs) if fg else cs.ts_rank(rank, refs)
    out["seconds"] = time.perf_counter() - t0
    grid.close()
    (OUT / f"rank{rank}.json").write_text(json.dumps(out))


def main():
    import torch
    from repro_torch.kernels import _build
    fg = "--fg" in sys.argv[1:]
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
    refs = cs.ts_serve_refs(torch.device("cuda"))
    (OUT / cs.TS_REFS).write_text(json.dumps(refs))
    print("one-card references", time.perf_counter() - t0, flush=True)
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_fn, args=(r, f"file://{OUT}/store", fg))
             for r in range(4)]
    with cs.dp_allocator_env():
        for p in procs:
            p.start()
    secs = cs.wait_world(procs, 500, "phase 13 world")
    per = [json.loads((OUT / f"rank{r}.json").read_text()) for r in range(4)]
    cs.emit({"phase": "tp serve", "world_seconds": secs,
             "rank_seconds": [p["seconds"] for p in per],
             "seconds_f_g": [p["seconds_f_g"] for p in per]})
    if fg:
        kern = [p["kernels"] for p in per]
        cs.emit({"phase": "tp serve", "check": "(c)", "per_rank": kern})
        cs.check(all(k["ok"] for ks in kern for k in ks.values()),
                 f"phase 13 (c): {kern}")
        counts = cs.ts_disagg_checks(smi, per, refs["disagg"])
        counts.update(cs.ts_colo_checks(smi, per, refs["colo"]))
    else:
        counts = cs.ts_checks(smi, per, per[0]["full_depth"]["tokens"],
                              refs)
    total = collections.defaultdict(int)
    for c in counts.values():
        for k, v in c.items():
            total[k] += v
    cs.kernel_times(torch.device("cuda"), total,
                    collections.defaultdict(float))
    print("phase13_alone ok", flush=True)


if __name__ == "__main__":
    main()
