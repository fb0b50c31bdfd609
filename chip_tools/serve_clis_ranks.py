"""The serving CLI across 4 ranks sharing the card (gloo), after the
kernels are built once (or found built): the fixed-batch mode on the
reference's smoke mesh (data 2, model 2) at full width and depth, and
two tenants of a (data 1, model 4) lease over one arbiter a rank on
phase 4's trace.
Prints each run's exit code, wall seconds and rank 0's summary; the
fixed-batch mode also one process on the card, beside.

    python3 chip_tools/serve_clis_ranks.py
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

BATCH = ["--arch", "qwen1.5-0.5b", "--batch", "8", "--prompt", "512",
         "--generate", "32"]
TENANTS = ["--arch", "qwen1.5-0.5b", "--requests", "16", "--max-new", "64",
           "--slots", "8", "--max-seq", "1024", "--page-size", "64",
           "--prompt-lens", "120,250,500", "--interarrival", "0.002",
           "--tier1-pages", "32", "--tier2-kv-gb", "4", "--tenants", "2",
           "--pool", "scalepool", "--pool-accels", "4",
           "--pool-model-parallel", "4"]


def run(name, argv, ranks, limit_s=300):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve"] + argv
    if ranks > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks)] + cmd[1:]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=limit_s, env={
                              **os.environ, "PYTHONPATH": str(ROOT / "src")})
    secs = time.perf_counter() - t0
    summary = json.loads(proc.stdout) if proc.returncode == 0 else None
    print(json.dumps({"run": name, "ranks": ranks, "rc": proc.returncode,
                      "seconds": secs, "summary": summary,
                      "stderr_tail": proc.stderr[-1500:]
                      if proc.returncode else ""}), flush=True)
    return proc.returncode


def main():
    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    rcs = [run("fixed batch", BATCH, 1), run("fixed batch", BATCH, 4),
           run("tenants", TENANTS, 4)]
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
