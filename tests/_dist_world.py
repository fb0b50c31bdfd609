"""A world of CPU ranks for the distributed tests.

``run_world(n, fn, out_dir, **kw)`` starts ``n`` processes, each running
``tests/_dist_ranks.py``'s ``fn(grid_env, out_dir, **kw)`` as rank
``RANK`` of ``WORLD_SIZE``, with ``torch.set_num_threads(1)`` and a
``file://`` store in ``out_dir`` (nothing shared between worlds, so
test workers never clash), and waits at most ``timeout`` seconds: on
expiry every rank is killed and the test fails.  A rank writes what it
found with ``torch.save`` under ``out_dir``; ``load(out_dir, name, r)``
reads it back.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = 120.0


def run_world(n: int, fn: str, out_dir, timeout: float = WORLD_TIMEOUT_S,
              **kw) -> float:
    """Run ``_dist_ranks.<fn>`` on ``n`` ranks; returns the wall seconds.
    Raises with every rank's output if one fails or the world overruns
    ``timeout``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "store"
    if store.exists():
        store.unlink()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n), OMP_NUM_THREADS="1",
               DIST_INIT=f"file://{store}")
    procs = []
    t0 = time.monotonic()
    for r in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, fn, str(out_dir), json.dumps(kw)],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(ROOT)))
    outs = []
    try:
        for p in procs:
            left = timeout - (time.monotonic() - t0)
            outs.append(p.communicate(timeout=max(left, 0.1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"world {fn} over {n} ranks overran "
                             f"{timeout} s; its ranks were killed")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"world {fn}: ranks failed {bad}:\n" + "\n".join(
            f"--- rank {r}\n{o[-3000:]}" for r, o in enumerate(outs)))
    return time.monotonic() - t0


def load(out_dir, name: str, rank: int):
    import torch
    return torch.load(Path(out_dir) / f"{name}.r{rank}.pt",
                      weights_only=False)


def _main():
    fn, out_dir, kw = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _dist_ranks
    getattr(_dist_ranks, fn)(out_dir, **kw)


if __name__ == "__main__":
    _main()
