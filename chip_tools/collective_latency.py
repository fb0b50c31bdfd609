"""Milliseconds a call of gloo collectives among 4 ranks sharing the
card, and what decides the port's choices in ``core.hierarchy``:

- a loopback TCP round trip (64 bytes, 1000 trips);
- on 16 KB host tensors of bf16 (8 x 1 x 1024, the serving engine's
  per-layer all-reduce at 8 rows), 100 calls each: gloo's all_reduce
  (a ring), all_gather_into_tensor, broadcast, and
  ``hierarchy._exchange_reduce`` (isend/irecv with every other rank,
  summed in rank order);
- gloo's ring against the exchange, over groups of 4 ranks and of 2, at
  16 KB to 4 MiB of bf16 and at phase 11's flat gradient buffer (fp32,
  qwen1.5-0.5b's first ``chip_smoke.DP_DEPTH`` layers; half of it over
  2 ranks, as the hierarchical mode's pod phase): on pinned host
  tensors (the algorithm alone), and staged from a card tensor as
  ``hierarchy._collective`` stages it (wait for the card, copy into a
  pinned buffer, reduce, copy back) through one pinned buffer kept
  across calls and through one allocated a call.

Prints, for each reading, the 4 ranks' milliseconds; writes them under
the ignored build/.

    python3 chip_tools/collective_latency.py
"""
import json, multiprocessing, os, socket, subprocess, sys, time
from pathlib import Path
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT)); sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "collective_latency"
SIZES = {"16KB": 8 * 1024, "64KB": 1 << 15, "256KB": 1 << 17,
         "512KB": 1 << 18, "1MiB": 1 << 19, "2MiB": 1 << 20,
         "4MiB": 1 << 21}           # bf16 elements
REPS = {"16KB": 100, "64KB": 100, "256KB": 50, "512KB": 30, "1MiB": 30,
        "2MiB": 20, "4MiB": 10, "flat": 2}


def timed(fn, reps):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def rank_fn(rank, init, flat_numel):
    import torch
    import torch.distributed as dist
    from repro_torch.core import hierarchy as H
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    grid = mesh_lib.init_grid(mesh_lib.Layout((2, 2), ("pod", "model")),
                              rank=rank, device=dev, init_method=init,
                              timeout_s=600)
    world = dist.group.WORLD
    res = {}

    def ring(o, i, g):
        dist.all_reduce(o, group=g)

    def exchange(o, i, g):
        H._exchange_reduce(o, i, g, "sum")

    # the 16 KB ops on host tensors
    t = torch.randn(8, 1, 1024).to(torch.bfloat16)
    out = torch.empty(4 * t.numel(), dtype=t.dtype)
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(t)),
            ("all_gather", lambda: dist.all_gather_into_tensor(
                out, t.reshape(-1))),
            ("broadcast", lambda: dist.broadcast(t, 0)),
            ("exchange", lambda: exchange(t, t, world))):
        dist.barrier()
        res[f"host 16KB {name}"] = timed(fn, 100)

    # ring against exchange, by group and size: alone, then staged
    shapes = {k: (n, torch.bfloat16) for k, n in SIZES.items()}
    shapes["flat"] = (flat_numel, torch.float32)
    for axes, n in ((("pod", "model"), 4), (("model",), 2)):
        g = grid.group(axes)
        for k, (numel, dtype) in shapes.items():
            numel = numel // 2 if (k == "flat" and n == 2) else numel
            host = torch.ones(numel, dtype=dtype, pin_memory=True)
            card = torch.ones(numel, dtype=dtype, device=dev)

            def staged(run, keep):
                torch.cuda.current_stream().synchronize()
                h = host if keep else torch.empty(numel, dtype=dtype,
                                                  pin_memory=True)
                h.copy_(card)
                run(h, h, g)
                card.copy_(h)

            for algo, run in (("ring", ring), ("exchange", exchange)):
                for how, fn in (
                        ("host", lambda: run(host, host, g)),
                        ("staged, pinned kept", lambda: staged(run, True)),
                        ("staged, pinned allocated",
                         lambda: staged(run, False))):
                    dist.barrier()
                    res[f"{n} ranks {k} {algo} {how}"] = timed(fn, REPS[k])
            del host, card
    grid.close()
    (OUT / f"r{rank}.json").write_text(json.dumps(res))


def pingpong():
    srv = socket.socket(); srv.bind(("127.0.0.1", 0)); srv.listen(1)
    port = srv.getsockname()[1]
    pid = os.fork()
    if pid == 0:
        c = socket.create_connection(("127.0.0.1", port))
        c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        for _ in range(1000):
            c.sendall(c.recv(64))
        os._exit(0)
    conn, _ = srv.accept()
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    t0 = time.perf_counter()
    for _ in range(1000):
        conn.sendall(b"x" * 64); conn.recv(64)
    dt = (time.perf_counter() - t0) / 1000 * 1e3
    os.waitpid(pid, 0)
    return dt


def flat_numel():
    """Phase 11's flat gradient buffer: every parameter of qwen1.5-0.5b's
    first ``DP_DEPTH`` layers, padded to the data axis (2)."""
    import torch
    import chip_smoke as cs
    from repro_torch.core.hierarchy import FlatTree
    from repro_torch.models.api import build_model
    model = build_model(cs.cut("qwen1.5-0.5b", cs.DP_DEPTH), device="cpu")
    return FlatTree(model.init(torch.Generator().manual_seed(0)), 2).padded


if __name__ == "__main__":
    import shutil
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    shutil.rmtree(OUT, ignore_errors=True); OUT.mkdir(parents=True)
    print("loopback tcp round trip ms", pingpong())
    n = flat_numel()
    print("phase 11 flat buffer elements", n)
    ctx = multiprocessing.get_context("spawn")
    ps = [ctx.Process(target=rank_fn, args=(r, f"file://{OUT}/store", n))
          for r in range(4)]
    for p in ps: p.start()
    for p in ps: p.join(900)
    print("exit codes", [p.exitcode for p in ps])
    per = [json.loads((OUT / f"r{r}.json").read_text()) for r in range(4)]
    for k in per[0]:
        print(f"{k:45s}", " ".join(f"{p[k]:10.3f}" for p in per))
