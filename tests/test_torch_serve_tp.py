"""The request-level engine under a ``model``-axis lease: m ranks over
gloo (``tests/_dist_world.py``, one thread a rank), each serving its
shards of qwen1.5-0.5b smoke (4 heads, 4 kv heads, 2 layers) in fp32 from
``Engine.from_lease`` on a ``(data 1, model m)`` lease, against the
reference's *local* engine (its lease path fails on this tree's jax,
ROADMAP C-ref1) on the same parameters (through numpy), the same burst
trace and the same explicit ``KVBudget``, whose tier-1 quota forces
spills and fetches:

* tokens, every handle's modeled clocks, the stats and the latency
  summary ``==`` the reference's on every rank, at m = 2 and 4 (and at
  m = 2 over a vocab of 250 padded to 256, whose last rank holds padded
  columns that must never win the argmax);
* the port's ``tracediff`` finds no divergence from the reference's
  trace, and the port's sanitizer passes every rank's;
* each rank's page pool holds its kv heads: layer 0 equal in bits to
  that head slice of the one-process port engine's pool, the later
  layer within 1e-5;
* ``tp.vocab_parallel_argmax`` equals ``torch.argmax`` over the real
  vocab on seeded rows with ties across a shard boundary, a maximum in
  the padded columns and a rank holding padding only, at m = 1, 2, 4;
* the serving CLI under ``torch.distributed.run --nproc-per-node 2``
  prints the one-process CLI's summary;
* what stays refused raises, naming its slice: heads that do not divide
  ``model`` (3g; attention heads, or the ssm and hybrid families' SSD
  heads on a model axis of 3, whisper smoke's 4 heads there too; moe
  gets past each of these entries' refusals to the grid's join, with a
  ``data`` axis over 1 or under ``model``, and so do ssm, hybrid and
  encdec under a model axis of 2 in the engine, its tenants, an engine
  on a shared transport and the fixed-batch session, the engines then
  refusing them for having no paged KV), a model axis in one process, a
  world that does not fill a
  (data 2, model 2) grid (the rules and the serving CLI); and ``grid=``
  on another layout than the lease's, and a disaggregated cluster whose
  decode engine is not on the exporting engine's grid.
"""

import concurrent.futures
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import serve as ref_serve                          # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import Tracer as RefTracer                     # noqa: E402
from repro.obs import to_chrome_trace as ref_chrome           # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import ROOT, load, run_world                 # noqa: E402

from repro_torch import analysis, bridge, serve               # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.disagg import DisaggCluster, PrefillWorker   # noqa: E402
from repro_torch.launch import mesh as mesh_lib               # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.models.config import ShapeConfig             # noqa: E402
from repro_torch.pool import smoke_pool                       # noqa: E402
from repro_torch.pool.lease import LeaseBinding               # noqa: E402
from repro_torch.launch import serve as serve_cli             # noqa: E402
from repro_torch.runtime.serve import make_lease_session      # noqa: E402
from repro_torch.sharding import tp                           # noqa: E402
from repro_torch.sharding.profiles import grid_refusal        # noqa: E402

ARCH = "qwen1.5-0.5b"
# the engine's shape and the trace: a 6-page quota of 8-token pages
# under 5 requests of 12 + 10 tokens forces spills and fetches
RUN = dict(n_requests=5, prompt_len=12, max_new=10, slots=3, max_seq=64,
           page_size=8, tier1_pages=6, tier2_bytes=1e9)
WORLDS = {"m2": (2, 256), "m4": (4, 256), "m2_vocab250": (2, 250)}
LATER_LAYERS_TOL = 1e-5
CLI_ARGS = ["--smoke", "--requests", "6", "--max-new", "12", "--slots", "3",
            "--max-seq", "96", "--page-size", "16", "--tier1-pages", "6",
            "--tier2-kv-gb", "1", "--prompt-lens", "24",
            "--interarrival", "0.0001", "--pool", "scalepool",
            "--pool-accels", "2", "--pool-model-parallel", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(vocab):
    ref = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32",
                              vocab=vocab)
    port = dataclasses.replace(get_config(ARCH, smoke=True),
                               compute_dtype="float32", vocab=vocab)
    return ref, port


def _reference(vocab, params_np):
    """The reference's local engine, traced, on the run's trace."""
    cfg, _ = _configs(vocab)
    model = ref_build(cfg)
    params = jax.tree.map(jax.numpy.asarray, params_np)
    tracer = RefTracer(1 << 16)
    eng = ref_serve.Engine.local(
        model, ref_serve.EngineConfig(max_slots=RUN["slots"],
                                      max_seq=RUN["max_seq"],
                                      page_size=RUN["page_size"]),
        params=params, tracer=tracer,
        budget=ref_serve.KVBudget(RUN["tier1_pages"], RUN["tier2_bytes"],
                                  RUN["page_size"]))
    trace = ref_serve.burst_trace(RUN["n_requests"],
                                  prompt_len=RUN["prompt_len"],
                                  max_new_tokens=RUN["max_new"],
                                  vocab=vocab, seed=0)
    handles = ref_serve.run_trace(eng, trace)
    return {"tokens": [h.tokens for h in handles],
            "clocks": [(h.submit_clock, h.first_token_clock, h.done_clock)
                       for h in handles],
            "latency": ref_serve.latency_summary(handles),
            "stats": eng.stats(), "trace": ref_chrome(tracer)}


def _one_process_pool(vocab, params_np):
    """The port's one-process engine on the same run: its page pool."""
    _, cfg = _configs(vocab)
    eng = serve.Engine.local(
        build_model(cfg, device="cpu"),
        serve.EngineConfig(max_slots=RUN["slots"], max_seq=RUN["max_seq"],
                           page_size=RUN["page_size"]),
        params=bridge.params_from_reference(params_np, "cpu"),
        budget=serve.KVBudget(RUN["tier1_pages"], RUN["tier2_bytes"],
                              RUN["page_size"]), device="cpu")
    serve.run_trace(eng, serve.burst_trace(
        RUN["n_requests"], prompt_len=RUN["prompt_len"],
        max_new_tokens=RUN["max_new"], vocab=vocab, seed=0))
    return eng._pool


# ---------------------------------------------------------------------------
# vocab_parallel_argmax's cases: rows of full (padded) logits
# ---------------------------------------------------------------------------

def _argmax_cases():
    """(logits (rows, 256), vocab, dtype) triples: seeded rows; equal
    maxima on both sides of every shard boundary of m = 2 and 4 (the
    lower index must win); the largest value in the padded columns (it
    must not); a vocab of 190, whose fourth quarter is all padding; bf16
    rows with many equal values."""
    rng = np.random.default_rng(3)
    cases = [(rng.standard_normal((5, 256)).astype(np.float32), 256, "f32"),
             (rng.standard_normal((5, 256)).astype(np.float32), 250, "f32")]
    tie = rng.standard_normal((4, 256)).astype(np.float32)
    for row, (a, b) in enumerate(((127, 128), (63, 64), (191, 192),
                                  (5, 200))):
        tie[row, [a, b]] = 9.0
    cases.append((tie, 256, "f32"))
    pad = rng.standard_normal((3, 256)).astype(np.float32)
    pad[:, 250:] = 50.0
    pad[1, 17] = pad[1, 249] = 7.0
    cases.append((pad, 250, "f32"))
    cases.append((rng.standard_normal((3, 256)).astype(np.float32), 190,
                  "f32"))
    coarse = (np.round(rng.standard_normal((6, 256)) * 2) / 2)
    cases.append((coarse.astype(np.float32), 250, "bf16"))
    return cases


def _tensor(logits, dtype):
    t = torch.from_numpy(logits)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world of ``WORLDS`` run once, all at once, beside the
    reference's run and the one-process port pool on the same
    parameters (computed while the worlds run)."""
    out, pending = {}, {}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        for name, (m, vocab) in WORLDS.items():
            d = tmp_path_factory.mktemp(f"serve_tp_{name}")
            ref_cfg, _ = _configs(vocab)
            params_np = jax.tree.map(np.asarray,
                                     ref_build(ref_cfg).init(
                                         jax.random.PRNGKey(0)))
            with open(d / "params.pkl", "wb") as f:
                pickle.dump(params_np, f)
            cases = ""
            if vocab == 256:
                arrays = {"n": len(_argmax_cases())}
                for k, (lg, v, dt) in enumerate(_argmax_cases()):
                    arrays[f"logits{k}"], arrays[f"vocab{k}"] = lg, v
                    arrays[f"bf16{k}"] = dt == "bf16"
                cases = str(d / "argmax.npz")
                np.savez(cases, **arrays)
            pending[name] = (d, params_np, pool.submit(
                run_world, m, "serve_tp", d, vocab=vocab,
                argmax_cases=cases, **RUN))
        for name, (d, params_np, _) in pending.items():
            m, vocab = WORLDS[name]
            out[name] = {"m": m, "vocab": vocab,
                         "ref": _reference(vocab, params_np),
                         "pool": _one_process_pool(vocab, params_np)}
        for name, (d, _, done) in pending.items():
            done.result()
            out[name]["ranks"] = [load(d, "serve_tp", r)
                                  for r in range(out[name]["m"])]
    return out


@pytest.mark.parametrize("world", list(WORLDS))
def test_every_rank_serves_the_reference_run(worlds, world):
    """Tokens, clocks, stats and latency ``==`` the reference's local
    engine's on every rank; the quota made the run spill and fetch."""
    w = worlds[world]
    ref = w["ref"]
    assert ref["stats"]["kv"]["spills"] > 0 < ref["stats"]["kv"]["fetches"]
    for rank in w["ranks"]:
        assert rank["grid"]["mesh"] == {"data": 1, "model": w["m"]}
        assert rank["tokens"] == ref["tokens"]
        assert rank["clocks"] == ref["clocks"]
        assert rank["latency"] == ref["latency"]
        assert rank["stats"] == ref["stats"]


@pytest.mark.parametrize("world", list(WORLDS))
def test_traces_equal_the_reference_and_sanitize(worlds, world):
    w = worlds[world]
    for rank in w["ranks"]:
        diff = analysis.diff_trace_docs(w["ref"]["trace"], rank["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(rank["trace"])
        assert report.ok, report.format()


@pytest.mark.parametrize("world", list(WORLDS))
def test_each_rank_pool_holds_its_kv_heads(worlds, world):
    """Layer 0 of each rank's pool equals its kv heads' slice of the
    one-process pool in bits; the later layer is within 1e-5 (the
    attention and MLP outputs are summed over ``model`` in another
    order); tier-2 charges price the whole model's page."""
    w = worlds[world]
    m = w["m"]
    for r, rank in enumerate(w["ranks"]):
        for name, full in w["pool"].items():
            kv = full.shape[3] // m
            want = full[..., r * kv:(r + 1) * kv, :]
            got = rank["pool"][name]
            assert got.shape == want.shape
            assert torch.equal(got[0], want[0]), (name, r)
            top = float(want[1:].abs().max())
            assert float((got[1:] - want[1:]).abs().max()) <= \
                LATER_LAYERS_TOL * top, (name, r)
        assert rank["page_bytes"] == w["ranks"][0]["page_bytes"]


@pytest.mark.parametrize("world", ["m2", "m4"])
def test_the_collectives_of_a_model_call(worlds, world):
    """Each prefill and decode: the lookup's, attention's and the MLP's
    all-reduces over ``model`` (1 + 2 per layer) and the argmax's one
    all-gather; the same on every rank."""
    w = worlds[world]
    names = [e["name"] for e in w["ref"]["trace"]["traceEvents"]]
    calls = names.count("prefill") + names.count("decode")
    layers = SMOKE_ARCHS[ARCH].n_layers
    for rank in w["ranks"]:
        assert rank["collectives"] == {
            "model:all-reduce": calls * (1 + 2 * layers),
            "model:all-gather": calls}


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("case", range(len(_argmax_cases())))
def test_vocab_parallel_argmax_is_torch_argmax(worlds, m, case):
    logits, vocab, dtype = _argmax_cases()[case]
    want = torch.argmax(_tensor(logits, dtype)[:, :vocab], dim=-1)
    if m == 1:
        got = [tp.vocab_parallel_argmax(_tensor(logits, dtype), vocab, None)]
    else:
        got = [r["argmax"][case] for r in worlds[f"m{m}"]["ranks"]]
    for g in got:
        assert torch.equal(g, want), (g, want)


# ---------------------------------------------------------------------------
# the CLI across two ranks
# ---------------------------------------------------------------------------

def _cli(*cmds):
    """Each command run at once; their (exit code, stdout, stderr)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT), env=env) for c in cmds]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def test_cli_across_two_ranks_prints_the_one_process_run():
    (rc1, out1, err1), (rc2, out2, err2) = _cli(
        [sys.executable, "-m", "repro_torch.launch.serve"] + CLI_ARGS
        + ["--device", "cpu"],
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve"]
        + CLI_ARGS + ["--device", "cpu"])
    assert rc1 == 0, err1
    assert rc2 == 0, err2
    one, two = json.loads(out1), json.loads(out2)
    assert two.pop("world") == 2 and two.pop("mesh") == {"data": 1,
                                                         "model": 2}
    assert two.pop("ranks_agree") is True
    for d in (one, two):
        d.pop("wall_s")
    assert two == one
    assert one["stats"]["kv"]["spills"] > 0


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

class _World:
    """A world of ranks as ``launch.mesh.running_world`` reads it from
    ``torch.distributed.run``'s environment; nothing is joined, since
    each refusal comes before the grid."""

    def __init__(self, monkeypatch, world: int):
        for k, v in (("WORLD_SIZE", world), ("RANK", 0), ("LOCAL_RANK", 0),
                     ("LOCAL_WORLD_SIZE", world)):
            monkeypatch.setenv(k, str(v))


def _ecfg():
    return serve.EngineConfig(max_slots=2, max_seq=64, page_size=8)


class _Joined(Exception):
    """Raised where an entry joins its lease's grid: nothing refused it."""


# the cases whose moe refusal the expert-parallel slice lifted: (world,
# the lease's model_parallel for moe, the family kept refused and its
# ROADMAP item: ssm, hybrid and encdec, which their sharded slices let
# through under a model axis of 2, on one of 3)
LIFTED = {"data": (4, 1, "mamba2-780m", "3g"),
          "session": (2, 1, "whisper-small", "3g"),
          "multi_tenant": (4, 1, "zamba2-7b", "3g"),
          "shared_fabric": (4, 1, "mamba2-780m", "3g"),
          "moe": (2, 2, "whisper-small", "3g")}


@pytest.mark.parametrize("case", ["heads", "data", "session",
                                  "multi_tenant", "shared_fabric", "moe",
                                  "one_process", "grid_layout",
                                  "handoff_grid", "world_fill"])
def test_what_stays_refused_names_its_slice(case, monkeypatch, capsys):
    """Each refusal names its slice.  Where expert parallelism lifted
    moe's (rows over a data axis of 4 in the engine, its tenants, an
    engine on a shared transport and the fixed-batch session; moe under
    a model axis of 2), olmoe smoke now gets past the refusal to the
    grid's join; the ssm, hybrid and encdec families get through to the
    join on a model axis of 2 and are refused on one of 3, where their
    8 SSD heads or whisper smoke's 4 heads do not divide it, naming
    3g."""
    qwen = build_model(get_config(ARCH, smoke=True), device="cpu")
    gen = torch.Generator().manual_seed(0)
    pool = smoke_pool("scalepool")
    world, arch, item, mp = {
        "heads": (2, "qwen3-14b", "3g", 2),
        "one_process": (1, ARCH, None, 2),
        "grid_layout": (2, ARCH, "layout", 2),
        "handoff_grid": (2, ARCH, "grid", 2),
        "world_fill": (2, ARCH, "fill", 2)}.get(case, (None,) * 4)
    if case in LIFTED:
        world, mp, arch, item = LIFTED[case]
        moe = build_model(get_config("olmoe-1b-7b", smoke=True),
                          device="cpu")

        def joined(self, *a, **kw):
            raise _Joined()
        monkeypatch.setattr(LeaseBinding, "join", joined)
    model = qwen if arch == ARCH else build_model(get_config(arch,
                                                             smoke=True),
                                                  device="cpu")
    _World(monkeypatch, world)

    def lease_of(model_parallel, name="tp", accels=4):
        return pool.lease(name, accels, tier2_gb=64, kv_gb=1.0,
                          model_parallel=model_parallel,
                          tenants=("a", "b") if case == "multi_tenant"
                          else ())
    lease = lease_of(mp)
    kw = {}
    if case == "shared_fabric":
        eng = serve.Engine.local(qwen, _ecfg(), generator=gen, device="cpu")
        kw = dict(transport=eng.transport, route=eng.route)
    if case == "multi_tenant":
        kw = dict(arbiter=serve.PoolArbiter(8, page_size=8), tenant="a")
    if case == "one_process":
        # two cards bound to one process: a model axis of 2, a world of 1
        one = lease.materialize
        monkeypatch.setattr(type(lease), "materialize",
                            lambda self, devices=None: one(["cpu", "cpu"]))
    if case in ("grid_layout", "handoff_grid"):
        # a grid of this rank's place, its groups never made: no engine
        # call below runs a collective
        shape = (2, 1) if case == "grid_layout" else (1, 2)
        kw = dict(grid=mesh_lib.RankGrid(
            mesh_lib.Layout(shape, ("data", "model")), 0,
            torch.device("cpu")))
    if case == "world_fill":
        # the serving CLI takes a (data 2, model 2) lease in a world of
        # 2 ranks: exit 2 before any work, naming the grid
        assert serve_cli.main(["--smoke", "--requests", "4", "--pool",
                               "scalepool", "--pool-accels", "4",
                               "--pool-model-parallel", "2", "--device",
                               "cpu"]) == 2
        said = capsys.readouterr().err
        assert "does not fill the grid" in said, said
        assert "{'data': 2, 'model': 2}" in said, said

    def enter(model, lease):
        if case == "world_fill":
            layout = mesh_lib.Layout((2, 2), ("data", "model"))
            why = grid_refusal(layout, qwen.cfg, serving=True, world=2)
            raise ValueError(why)
        if case == "session":
            make_lease_session(model, ShapeConfig("s", "decode", 64, 2),
                               lease, device="cpu")
        elif case == "handoff_grid":
            decode = serve.Engine.from_lease(model, lease, _ecfg(),
                                             generator=gen, device="cpu",
                                             **kw)
            exporter = serve.Engine.local(qwen, _ecfg(), generator=gen,
                                          device="cpu")
            DisaggCluster([PrefillWorker(exporter)], [decode])
        else:
            serve.Engine.from_lease(model, lease, _ecfg(), generator=gen,
                                    device="cpu", **kw)
    if case in LIFTED:
        with pytest.raises(_Joined):
            enter(moe, lease)
        if mp == 1:
            lease = lease_of(2, "tp-model")
            _World(monkeypatch, 4)
        if model.cfg.family in ("ssm", "hybrid", "encdec"):
            with pytest.raises(_Joined):
                enter(model, lease)
            lease = lease_of(3, "tp-three", accels=3)
            _World(monkeypatch, 3)
    with pytest.raises(ValueError) as err:
        enter(model, lease)
    msg = str(err.value)
    if item is None:
        assert "needs a world of 2 ranks" in msg, msg
    elif item == "fill":
        assert "needs a world of 4 ranks" in msg and "not 2" in msg, msg
    elif item == "layout":
        assert "not on the lease's {'data': 1, 'model': 2}" in msg, msg
    elif item == "grid":
        assert "not on the exporting engine's grid (one process)" in msg, msg
    else:
        assert f"ROADMAP Queue A {item}" in msg and "later slice" in msg, msg
