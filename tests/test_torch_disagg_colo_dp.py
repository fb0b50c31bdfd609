"""Disaggregated tiers and co-resident engines on a lease with a ``data``
axis over 1: (data 2, model 2), 4 ranks over gloo
(``tests/_dist_world.py``, one thread a rank), qwen1.5-0.5b smoke in
fp32 from the reference's parameters (through numpy).  Each engine
decodes its block of each decode bucket's rows on its ``model`` block of
heads, its page pool replicated over ``data`` and kept equal by one
all-gather a decode step; a rank's exported pages hold its kv heads,
the same on both data replicas.

* **Disagg:** ``tests/_disagg_scenarios.py``'s direct and ``tier2``
  clusters, every engine of both tiers from the members of one
  ``lease_gang`` of 4 accelerators each with ``model_parallel=2``, on
  one grid, with 4 decode rows an engine (so the data axis splits them);
  held to the reference's ``DisaggCluster`` over ``Engine.local`` with
  the same engines: tokens, every handle's clocks, ``kv_transit_s``,
  handoffs and colocated requests, ``Transport.stats()`` and the decode
  engines' stats ``==`` on every rank; ``tracediff`` finds no
  divergence, the sanitizer passes every rank's trace and exercises
  ``disagg-handoff``; the data replicas' decode pools are equal in bits.
* **Colo:** fig11's hop-only run at its racecheck shape (4 requests a
  tenant, 4 training steps, 6-slot engines; ``chip_smoke.co_run``) with
  both tenants' engines from one (data 2, model 2) lease, against the
  reference's ``run_colo``: tokens, latencies, p95s, ``train_stats()``,
  ``link_report`` and ``Transport.stats()``, every handle's and engine's
  clock and the engines' stats ``==`` on every rank; the traces as
  above; both engines on one grid, their replicas' pools equal in bits.
"""

import concurrent.futures
import dataclasses
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from benchmarks import fig11_colocation as fig11              # noqa: E402
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
from _dist_world import load, run_world                       # noqa: E402
from test_torch_colo_fig11 import (FULL_CFG, _clocks,          # noqa: E402
                                   _ref_traced, cs)

from repro_torch import analysis                              # noqa: E402

ARCH = "qwen1.5-0.5b"
VOCAB = SMOKE_ARCHS[ARCH].vocab
WORLD, MODEL = 4, 2
MESH = {"data": 2, "model": 2}
SLOTS = 4                       # decode rows an engine: the data axis
                                # splits them (the scenarios' 3 it
                                # would not)
DISAGG_CASES = ("direct", "tier2")
REF = types.SimpleNamespace(
    serve=ref_serve, disagg=ref_disagg, fb=ref_fb, Topology=RefTopology,
    Transport=RefTransport, Tracer=RefTracer)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_disagg(model, params):
    """{case: (outcome, trace)} of the reference's local clusters."""
    out = {}
    for case in DISAGG_CASES:
        def engine(role, tenant, tracer):
            return ref_serve.Engine.local(
                model, dataclasses.replace(D.engine_config(REF),
                                           max_slots=SLOTS),
                params=params, budget=D.budget(REF, role), tenant=tenant,
                tracer=tracer)
        cluster, tx, handles, tracer = D.run(REF, case, engine, VOCAB)
        assert tracer.dropped == 0
        out[case] = (D.outcome(cluster, tx, handles), ref_chrome(tracer))
    return out


def _ref_colo(model, params):
    """The reference's hop-only fig11 run, traced: (run, trace, bw)."""
    probe = ref_serve.Engine.local(
        model, ref_serve.EngineConfig(
            max_slots=fig11.SLOTS, max_seq=fig11.PROMPT + fig11.MAX_NEW,
            page_size=fig11.PAGE),
        params=params,
        budget=ref_serve.KVBudget(fig11.QUOTA, 1e9, fig11.PAGE))
    bw = fig11._page_bw(FULL_CFG, probe.kv.page_bytes)
    traces = {t: ref_serve.burst_trace(
        cs.CO_RACE_REQUESTS, prompt_len=fig11.PROMPT,
        max_new_tokens=fig11.MAX_NEW, vocab=VOCAB, seed=i)
        for i, t in enumerate(fig11.TENANTS)}
    tracer = RefTracer(1 << 18)
    ref = _ref_traced("scalepool", model, params, traces, bw,
                      cs.CO_RACE_STEPS, tracer)
    assert tracer.dropped == 0
    return ref, ref_chrome(tracer), bw


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once, beside the reference's runs."""
    root = tmp_path_factory.mktemp("serve_dp_tiers")
    cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32")
    model = ref_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    dirs = {k: root / k for k in ("disagg", "colo")}
    for d in dirs.values():
        d.mkdir()
        with open(d / "params.pkl", "wb") as f:
            pickle.dump(params_np, f)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        done = {
            "disagg": pool.submit(
                run_world, WORLD, "serve_disagg", dirs["disagg"],
                vocab=VOCAB, cases=list(DISAGG_CASES), model_parallel=MODEL,
                slots=SLOTS),
            "colo": pool.submit(
                run_world, WORLD, "serve_colo", dirs["colo"], vocab=VOCAB,
                n_requests=cs.CO_RACE_REQUESTS, n_steps=cs.CO_RACE_STEPS,
                model_parallel=MODEL)}
        refs = {"disagg": _ref_disagg(model, params),
                "colo": _ref_colo(model, params)}
        ranks = {}
        for k, f in done.items():
            f.result()
            ranks[k] = [load(dirs[k], f"serve_{k}", r) for r in range(WORLD)]
    return refs, ranks


def _replicas_equal(pools_by_rank, kv_heads_by_rank):
    """The pools of the ranks that hold one block of kv heads are equal
    in bits (the trash page already cut off)."""
    first = {}
    for pools, heads in zip(pools_by_rank, kv_heads_by_rank):
        seen = first.setdefault(heads, pools)
        for name in pools:
            assert torch.equal(pools[name], seen[name]), (name, heads)
    assert len(first) == MODEL


@pytest.mark.parametrize("case", DISAGG_CASES)
def test_tiers_serve_the_reference_cluster(worlds, case):
    refs, ranks = worlds
    want, _ = refs["disagg"][case]
    assert all(s == "done" for s in want["status"])
    assert want["handoffs"] > 0 and want["transport"]["transfers"] > 0
    for rank in ranks["disagg"]:
        assert rank["layouts"] == {"prefill": MESH, "decode": MESH}
        got = rank["cases"][case]
        assert {k: got[k] for k in want} == want
        assert got["dropped"] == 0 and got["one_grid"]
        assert "data:all-gather" in rank["collectives"]


@pytest.mark.parametrize("case", DISAGG_CASES)
def test_tier_traces_equal_the_reference_and_sanitize(worlds, case):
    refs, ranks = worlds
    _, ref_trace = refs["disagg"][case]
    for rank in ranks["disagg"]:
        got = rank["cases"][case]
        diff = analysis.diff_trace_docs(ref_trace, got["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(got["trace"])
        assert report.ok, report.format()
        assert report.checks["disagg-handoff"] > 0


@pytest.mark.parametrize("case", DISAGG_CASES)
def test_decode_replicas_hold_the_same_pool(worlds, case):
    _, ranks = worlds
    n_kv = SMOKE_ARCHS[ARCH].n_kv_heads // MODEL
    pools, heads = [], []
    for rank in ranks["disagg"]:
        got = rank["cases"][case]
        pools.append({f"{e}/{k}": v[:, :got["trash"][e]]
                      for e, p in enumerate(got["pools"])
                      for k, v in p.items()})
        model_index = rank["grid"]["coords"]["model"]
        want = (model_index * n_kv, (model_index + 1) * n_kv)
        assert set(got["kv_heads"]) == {want}
        heads.append(want)
    _replicas_equal(pools, heads)


def test_colo_serves_the_reference_run(worlds):
    refs, ranks = worlds
    ref, _, bw = refs["colo"]
    assert ref["transport"]["contended_transfers"] > 0
    assert ref["train"]["steps"] == cs.CO_RACE_STEPS
    for rank in ranks["colo"]:
        assert rank["mesh"] == MESH and rank["one_grid"]
        assert rank["bw"] == bw
        assert rank["outcome"] == cs.co_outcome(ref)
        assert rank["clocks"] == _clocks(ref)
        assert rank["engine_clocks"] == {t: e.clock for t, e
                                         in ref["engines"].items()}
        assert rank["stats"] == {t: e.stats() for t, e
                                 in ref["engines"].items()}
        assert rank["collectives"]["data:all-gather"] > 0


def test_colo_traces_equal_the_reference_and_replicas_agree(worlds):
    refs, ranks = worlds
    _, ref_trace, _ = refs["colo"]
    pools, heads = [], []
    for rank in ranks["colo"]:
        assert rank["dropped"] == 0
        diff = analysis.diff_trace_docs(ref_trace, rank["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(rank["trace"])
        assert report.ok, report.format()
        for rule in ("kv-conservation", "link-conservation",
                     "transfer-causality"):
            assert report.checks[rule] > 0, rule
        assert len(set(rank["kv_heads"])) == 1
        pools.append({f"{t}/{k}": v for t, p in rank["pools"].items()
                      for k, v in p.items()})
        heads.append(rank["kv_heads"][0])
    _replicas_equal(pools, heads)
