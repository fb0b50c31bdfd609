"""Each kernel source's nvcc time on the card's machine: every source
started at once, as ``repro_torch.kernels._build`` builds them (its
``PARTS`` ignored: each source in one nvcc), each one's finish time
printed, then the two slowest compiled alone.

    python3 chip_tools/build_times.py
"""
import subprocess, sys, tempfile, time
from pathlib import Path
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build as B
nvcc = B._nvcc()
tmp = Path(tempfile.mkdtemp())
def cmd(name):
    return [nvcc, *B.NVCC_FLAGS, "-I", str(B.CSRC), "-c", str(B.CSRC / name), "-o", str(tmp / (name + ".o"))]
t0 = time.perf_counter()
procs = {n: subprocess.Popen(cmd(n), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for n in B.SOURCES}
done = {}
while len(done) < len(procs):
    for n, p in procs.items():
        if n not in done and p.poll() is not None:
            done[n] = time.perf_counter() - t0
    time.sleep(0.05)
for n, t in sorted(done.items(), key=lambda x: x[1]):
    print(f"together {t:6.1f} {n}")
slow = max(done, key=done.get)
for n in (slow, sorted(done, key=done.get)[-2]):
    t1 = time.perf_counter(); subprocess.run(cmd(n), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    print(f"alone {time.perf_counter() - t1:6.1f} {n}")
