"""Disaggregated prefill/decode under a ``model``-axis lease.

On m = 2 and 4 ranks over gloo (``tests/_dist_world.py``, one thread a
rank), every rank holds both tiers of a ``DisaggCluster``: each prefill
worker's engine and each decode engine an ``Engine.from_lease(...,
grid=)`` of a member of one ``ResourcePool.lease_gang`` with
``model_parallel=m``, all on one (data 1, model m) grid, serving
qwen1.5-0.5b smoke in fp32 from the reference's parameters (through
numpy).  The scenarios (``tests/_disagg_scenarios.py``: fig12's shape at
smoke size) are direct, ``tier2`` staging with ``min_ready_pages=1``, a
``max_transit_s`` that sends the longer prompts colocated, 2 prefill
workers with 2 decode engines, and the degenerate cluster; each is held
to the reference's ``DisaggCluster`` over ``Engine.local`` (its lease
path stops at C-ref1):

* on every rank, tokens, every handle's clocks, ``kv_transit_s``,
  handoffs and colocated requests, ``Transport.stats()`` and each decode
  engine's stats ``==`` the reference's;
* the port's ``tracediff`` finds no divergence from the reference's
  trace, and the port's sanitizer passes every rank's, its
  ``disagg-handoff`` rule exercised wherever pages were handed off;
* each rank's decode pools hold its kv heads: layer 0 equal in bits to
  that slice of the one-process port run's pools, the later layer
  within 1e-5;
* both gang members materialize one layout, every engine serves on the
  one grid, and a decode engine on a second grid is refused.

The CLI's ``--disagg`` on 2 ranks under ``torch.distributed.run`` (a
``--pool`` gang with ``--pool-model-parallel 2``) prints the one-process
CLI's summary with ``ranks_agree``, and rank 0 writes ``--trace-out``.
"""

import concurrent.futures
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import disagg as ref_disagg                        # noqa: E402
from repro import serve as ref_serve                          # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.core import fabric as ref_fb                       # noqa: E402
from repro.fabric import Topology as RefTopology              # noqa: E402
from repro.fabric import Transport as RefTransport            # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import Tracer as RefTracer                     # noqa: E402
from repro.obs import to_chrome_trace as ref_chrome           # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _disagg_scenarios as D                                 # noqa: E402
from _dist_world import ROOT, load, run_world                 # noqa: E402

from repro_torch import analysis, bridge, disagg, serve       # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.core import fabric as fb                     # noqa: E402
from repro_torch.fabric import Topology, Transport            # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.obs import Tracer                            # noqa: E402

ARCH = "qwen1.5-0.5b"
VOCAB = SMOKE_ARCHS[ARCH].vocab
WORLDS = (2, 4)
LATER_LAYERS_TOL = 1e-5
CLI = ["--smoke", "--requests", "8", "--max-new", "6", "--slots", "3",
       "--max-seq", "96", "--page-size", "16", "--prompt-lens", "32,16",
       "--interarrival", "0.001", "--disagg", "--disagg-staging", "tier2",
       "--min-ready-pages", "1", "--tier1-pages", "8", "--tier2-kv-gb", "1"]
CLI_POOL = ["--pool", "scalepool", "--pool-accels", "2",
            "--pool-model-parallel", "2"]

REF = types.SimpleNamespace(
    serve=ref_serve, disagg=ref_disagg, fb=ref_fb, Topology=RefTopology,
    Transport=RefTransport, Tracer=RefTracer, chrome=ref_chrome, kw={})
PORT = types.SimpleNamespace(
    serve=serve, disagg=disagg, fb=fb, Topology=Topology,
    Transport=Transport, Tracer=Tracer, kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _local_runs(S, model, params):
    """Every case on local engines of ``S`` (the reference, or the port
    in one process): {case: (outcome, trace or None, decode pools)}."""
    out = {}
    for case in D.CASES:
        def engine(role, tenant, tracer):
            return S.serve.Engine.local(
                model, D.engine_config(S), params=params,
                budget=D.budget(S, role), tenant=tenant, tracer=tracer,
                **S.kw)
        cluster, tx, handles, tracer = D.run(S, case, engine, VOCAB)
        assert tracer.dropped == 0
        out[case] = (D.outcome(cluster, tx, handles),
                     S.chrome(tracer) if S is REF else None,
                     [dict(e._pool) for e in cluster.decode_engines]
                     if S is PORT else None)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once, beside the reference's local runs and the
    one-process port runs on the same parameters."""
    root = tmp_path_factory.mktemp("serve_disagg")
    cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32")
    ref_model = ref_build(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, ref_params)
    pending = {}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        for m in WORLDS:
            d = root / f"m{m}"
            d.mkdir()
            with open(d / "params.pkl", "wb") as f:
                pickle.dump(params_np, f)
            pending[m] = (d, pool.submit(run_world, m, "serve_disagg", d,
                                         vocab=VOCAB, cases=list(D.CASES)))
        ref = _local_runs(REF, ref_model, ref_params)
        port = build_model(dataclasses.replace(get_config(ARCH, smoke=True),
                                               compute_dtype="float32"),
                           device="cpu")
        one = _local_runs(PORT, port,
                          bridge.params_from_reference(params_np, "cpu"))
        out = {}
        for m, (d, done) in pending.items():
            done.result()
            out[m] = [load(d, "serve_disagg", r) for r in range(m)]
    return ref, one, out


CASES = [(m, c) for m in WORLDS for c in D.CASES]
IDS = [f"m{m}-{c}" for m, c in CASES]


@pytest.mark.parametrize("m,case", CASES, ids=IDS)
def test_tiers_serve_the_reference_cluster(worlds, m, case):
    ref, _, ranks = worlds
    want = ref[case][0]
    assert all(s == "done" for s in want["status"])
    if case == "colocated_fallback":
        assert want["handoffs"] == want["colocated"] == D.N_EACH
    if case == "degenerate":
        assert want["handoffs"] == 0 and want["transport"] is None
    else:
        assert want["transport"]["transfers"] > 0
    for rank in ranks[m]:
        got = rank["cases"][case]
        assert {k: got[k] for k in want} == want
        assert got["dropped"] == 0


@pytest.mark.parametrize("m,case", CASES, ids=IDS)
def test_tier_traces_equal_the_reference_and_sanitize(worlds, m, case):
    ref, _, ranks = worlds
    for rank in ranks[m]:
        got = rank["cases"][case]
        diff = analysis.diff_trace_docs(ref[case][1], got["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(got["trace"])
        assert report.ok, report.format()
        if got["handoffs"]:
            assert report.checks["disagg-handoff"] > 0


@pytest.mark.parametrize("m", WORLDS)
def test_each_rank_decode_pool_holds_its_kv_heads(worlds, m):
    _, one, ranks = worlds
    for r, rank in enumerate(ranks[m]):
        for case in D.CASES:
            for full, got in zip(one[case][2], rank["cases"][case]["pools"]):
                for name, leaf in full.items():
                    kv = leaf.shape[3] // m
                    want = leaf[..., r * kv:(r + 1) * kv, :]
                    assert got[name].shape == want.shape
                    assert torch.equal(got[name][0], want[0]), (case, r)
                    top = float(want[1:].abs().max())
                    assert float((got[name][1:] - want[1:]).abs().max()) \
                        <= LATER_LAYERS_TOL * top, (case, name, r)


@pytest.mark.parametrize("m", WORLDS)
def test_tiers_share_one_grid_from_one_gang(worlds, m):
    _, _, ranks = worlds
    n_kv = SMOKE_ARCHS[ARCH].n_kv_heads // m
    for r, rank in enumerate(ranks[m]):
        assert rank["layouts"] == {"prefill": {"data": 1, "model": m},
                                   "decode": {"data": 1, "model": m}}
        assert rank["grid"]["mesh"] == {"data": 1, "model": m}
        for case, got in rank["cases"].items():
            assert got["one_grid"], case
            assert set(got["kv_heads"]) == {(r * n_kv, (r + 1) * n_kv)}
        assert "not on the exporting engine's grid" in rank["refusal"]
        assert rank["collectives"]


# ---------------------------------------------------------------------------
# the CLI's --disagg across two ranks
# ---------------------------------------------------------------------------

def test_cli_disagg_across_two_ranks_prints_the_one_process_run(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    one = [sys.executable, "-m", "repro_torch.launch.serve"] + CLI + [
        "--device", "cpu", "--trace-out", str(tmp_path / "one.json")]
    two = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.serve"
           ] + CLI + CLI_POOL + ["--device", "cpu", "--trace-out",
                                 str(tmp_path / "two.json")]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT), env=env) for c in (one, two)]
    try:
        (out1, err1), (out2, err2) = [p.communicate(timeout=120)
                                      for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert procs[0].returncode == 0, err1
    assert procs[1].returncode == 0, err2
    a, b = json.loads(out1), json.loads(out2)
    assert b.pop("world") == 2
    assert b.pop("mesh") == {"data": 1, "model": 2}
    assert b.pop("ranks_agree") is True
    for d in (a, b):
        d.pop("wall_s")
        assert d["trace_out"].pop("path")
    assert b == a
    assert a["handoffs"] == 8
    report = analysis.sanitize_trace_file(str(tmp_path / "two.json"))
    assert report.ok, report.format()
    assert report.checks["disagg-handoff"] > 0


def test_submit_prefilled_refuses_pages_of_another_kv_head_block(
        monkeypatch):
    """A decode engine on a (data 1, model 2) grid holds 2 of the smoke
    model's 4 kv heads: the pages of a one-process exporter (all 4) are
    refused at the seam, before a copy could broadcast them."""
    for k, v in (("WORLD_SIZE", 2), ("RANK", 0), ("LOCAL_RANK", 0),
                 ("LOCAL_WORLD_SIZE", 2)):
        monkeypatch.setenv(k, str(v))
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.pool import smoke_pool
    model = build_model(get_config(ARCH, smoke=True), device="cpu")
    gen = torch.Generator().manual_seed(0)
    ecfg = D.engine_config(PORT)
    lease = smoke_pool("scalepool").lease("tp", 2, model_parallel=2)
    # this rank's place on the grid, its groups never made: nothing
    # below runs a collective
    grid = mesh_lib.RankGrid(mesh_lib.Layout((1, 2), ("data", "model")), 0,
                             torch.device("cpu"))
    decode = serve.Engine.from_lease(model, lease, ecfg, generator=gen,
                                     grid=grid, device="cpu")
    exporter = serve.Engine.local(model, ecfg, generator=gen, device="cpu")
    assert decode.kv_heads == (0, 2) and exporter.kv_heads == (0, 4)
    tok, pages, _ = exporter.prefill_export((1, 2, 3))
    with pytest.raises(ValueError, match="kv-head block"):
        decode.submit_prefilled(serve.Request((1, 2, 3), 4), first_tok=tok,
                                prefill_done=0.0, pages=pages,
                                page_ready=[0.0])
