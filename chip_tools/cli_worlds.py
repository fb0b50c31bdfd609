"""chip_smoke.py's three training-CLI worlds together on the card, several
rounds: phase 12 (d)'s plain world and its world restart and phase 11
(d)'s world (``chip_smoke.tp_cli_start``, 12 ranks under
``torch.distributed.run``), after the kernels are built once.  With
``--hog GB`` this process holds that many GB of the card while a round
runs, in place of phase 12's world beside them.  Each round prints each
world's exit code, seconds and, where one failed, its first traceback
(``chip_smoke.cli_error``), and the least free memory of the card seen
during the round (sampled every 0.5 s).

    python3 chip_tools/cli_worlds.py --rounds 2
    python3 chip_tools/cli_worlds.py --rounds 2 --hog 40
"""
import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs                                       # noqa: E402


def one_round(hog_gb: float) -> dict:
    import torch
    for d in (cs.DP_DIR, cs.TP_DIR):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    hog = (torch.empty(int(hog_gb * 1e9), dtype=torch.uint8, device="cuda")
           if hog_gb else None)
    least = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    clis = cs.tp_cli_start() + [cs.dp_cli_start()]
    names = ("phase 12 (d) plain", "phase 12 (d) restart", "phase 11 (d)")
    while any(proc.poll() is None for proc, _ in clis):
        least = min(least, torch.cuda.mem_get_info()[0])
        time.sleep(0.5)
    out = {"hog_gb": hog_gb, "seconds": time.perf_counter() - t0,
           "least_free_gb": least / 1e9, "worlds": {}}
    for name, (_, wait) in zip(names, clis):
        rc, _, err, secs = wait()
        out["worlds"][name] = {"rc": rc, "seconds": secs,
                               "error": cs.cli_error(err) if rc else None}
    del hog
    torch.cuda.empty_cache()
    return out


def main():
    import torch
    from repro_torch.kernels import _build
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--hog", type=float, default=0.0)
    args = p.parse_args()
    print(cs.nvidia_smi_line(), flush=True)
    _build.build()              # reuses a library built from these sources
    _build.library()
    torch.cuda.init()
    failed = 0
    for k in range(args.rounds):
        r = one_round(args.hog)
        failed += sum(w["rc"] != 0 for w in r["worlds"].values())
        print(json.dumps({"round": k + 1, **r}), flush=True)
    print(json.dumps({"rounds": args.rounds, "hog_gb": args.hog,
                      "worlds_failed": failed}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
