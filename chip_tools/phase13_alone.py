"""chip_smoke.py's phase 13 alone on the card: the kernels built, 4
spawned ranks sharing the card on a (data 1, model 4) world running
``chip_smoke.ts_rank`` on one torch thread each (as ``tp_rank``), the
parent's checks (``ts_checks``, phase 13 (b)'s tokens standing in for
phase 4's), then phase 5's times.

    python3 chip_tools/phase13_alone.py
"""
import collections, json, multiprocessing, shutil, sys, time
from pathlib import Path
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT)); sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs
OUT = ROOT / "build" / "phase13_alone"


def rank_fn(rank, init):
    import torch
    from repro_torch.launch import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    grid = mesh_lib.init_grid(mesh_lib.Layout((1, 4), ("data", "model")),
                              rank=rank, device=torch.device("cuda", 0),
                              init_method=init, timeout_s=180)
    t0 = time.perf_counter()
    out = cs.ts_rank(rank)
    out["seconds"] = time.perf_counter() - t0
    grid.close()
    (OUT / f"rank{rank}.json").write_text(json.dumps(out))


def main():
    import torch
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    print("build", time.perf_counter() - t0, flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_fn, args=(r, f"file://{OUT}/store"))
             for r in range(4)]
    with cs.dp_allocator_env():
        for p in procs:
            p.start()
    secs = cs.wait_world(procs, 400, "phase 13 world")
    per = [json.loads((OUT / f"rank{r}.json").read_text()) for r in range(4)]
    cs.emit({"phase": "tp serve", "world_seconds": secs,
             "rank_seconds": [p["seconds"] for p in per]})
    counts = cs.ts_checks(smi, per, per[0]["full_depth"]["tokens"])
    total = collections.defaultdict(int)
    for c in counts.values():
        for k, v in c.items():
            total[k] += v
    cs.kernel_times(torch.device("cuda"), total,
                    collections.defaultdict(float))
    print("phase13_alone ok", flush=True)


if __name__ == "__main__":
    main()
