"""Disaggregated tiers and co-resident engines serving the moe family on
a (data 2, model 2) lease: 4 ranks over gloo (``tests/_dist_world.py``,
one thread a rank), olmoe-1b-7b smoke in fp32 from the reference's
parameters, its experts over ``model`` and each decode bucket's rows
over ``data`` with the dispatch group the whole bucket.  The harnesses
of ``tests/test_torch_disagg_colo_dp.py`` (``_dist_ranks.serve_disagg``
and ``serve_colo``, their checks) with the moe config:

* **Disagg:** ``tests/_disagg_scenarios.py``'s direct cluster, every
  engine of both tiers from one ``lease_gang`` on one grid, 4 decode
  rows an engine, held to the reference's ``DisaggCluster`` over
  ``Engine.local``: its outcome (tokens, clocks, transit, handoffs,
  transport and decode stats) ``==`` on every rank, ``tracediff`` finds
  no divergence, the sanitizer passes and exercises ``disagg-handoff``,
  the data replicas' decode pools equal in bits;
* **Colo:** fig11's hop-only run at its racecheck shape against the
  reference's ``run_colo`` on the same model: the outcome, every
  handle's and engine's clock and the engines' stats ``==``, the traces
  as above, the replicas' pools equal in bits.
"""

import concurrent.futures
import dataclasses
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import to_chrome_trace as ref_chrome           # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _disagg_scenarios as D                                 # noqa: E402
import test_torch_disagg_colo_dp as dp                        # noqa: E402
from _dist_world import load, run_world                       # noqa: E402
from test_torch_colo_fig11 import _clocks, cs                 # noqa: E402

from repro_torch import analysis                              # noqa: E402

ARCH = "olmoe-1b-7b"
VOCAB = SMOKE_ARCHS[ARCH].vocab
CASE = "direct"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_direct(model, params):
    """The reference's local direct cluster: (outcome, trace)."""
    def engine(role, tenant, tracer):
        return dp.ref_serve.Engine.local(
            model, dataclasses.replace(D.engine_config(dp.REF),
                                       max_slots=dp.SLOTS),
            params=params, budget=D.budget(dp.REF, role), tenant=tenant,
            tracer=tracer)
    cluster, tx, handles, tracer = D.run(dp.REF, CASE, engine, VOCAB)
    assert tracer.dropped == 0
    return D.outcome(cluster, tx, handles), ref_chrome(tracer)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once, beside the reference's runs."""
    root = tmp_path_factory.mktemp("serve_moe_tiers")
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
                run_world, dp.WORLD, "serve_disagg", dirs["disagg"],
                vocab=VOCAB, cases=[CASE], model_parallel=dp.MODEL,
                slots=dp.SLOTS, arch=ARCH),
            "colo": pool.submit(
                run_world, dp.WORLD, "serve_colo", dirs["colo"], vocab=VOCAB,
                n_requests=cs.CO_RACE_REQUESTS, n_steps=cs.CO_RACE_STEPS,
                model_parallel=dp.MODEL, arch=ARCH)}
        refs = {"disagg": _ref_direct(model, params),
                "colo": dp._ref_colo(model, params)}
        ranks = {}
        for k, f in done.items():
            f.result()
            ranks[k] = [load(dirs[k], f"serve_{k}", r)
                        for r in range(dp.WORLD)]
    return refs, ranks


def test_moe_direct_tiers_serve_the_reference_cluster(worlds):
    refs, ranks = worlds
    want, ref_trace = refs["disagg"]
    assert all(s == "done" for s in want["status"])
    assert want["handoffs"] > 0 and want["transport"]["transfers"] > 0
    pools, heads = [], []
    for rank in ranks["disagg"]:
        assert rank["layouts"] == {"prefill": dp.MESH, "decode": dp.MESH}
        got = rank["cases"][CASE]
        assert {k: got[k] for k in want} == want
        assert got["dropped"] == 0 and got["one_grid"]
        assert rank["collectives"]["data:all-gather:moe-experts"] > 0
        diff = analysis.diff_trace_docs(ref_trace, got["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(got["trace"])
        assert report.ok, report.format()
        assert report.checks["disagg-handoff"] > 0
        pools.append({f"{e}/{k}": v[:, :got["trash"][e]]
                      for e, p in enumerate(got["pools"])
                      for k, v in p.items()})
        heads.append(got["kv_heads"][0])
    dp._replicas_equal(pools, heads)


def test_moe_colo_serves_the_reference_run(worlds):
    refs, ranks = worlds
    ref, ref_trace, bw = refs["colo"]
    assert ref["train"]["steps"] == cs.CO_RACE_STEPS
    pools, heads = [], []
    for rank in ranks["colo"]:
        assert rank["mesh"] == dp.MESH and rank["one_grid"]
        assert rank["bw"] == bw
        assert rank["outcome"] == cs.co_outcome(ref)
        assert rank["clocks"] == _clocks(ref)
        assert rank["engine_clocks"] == {t: e.clock for t, e
                                         in ref["engines"].items()}
        assert rank["stats"] == {t: e.stats() for t, e
                                 in ref["engines"].items()}
        assert rank["collectives"]["data:all-gather:moe-experts"] > 0
        assert rank["dropped"] == 0
        diff = analysis.diff_trace_docs(ref_trace, rank["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(rank["trace"])
        assert report.ok, report.format()
        pools.append({f"{t}/{k}": v for t, p in rank["pools"].items()
                      for k, v in p.items()})
        heads.append(rank["kv_heads"][0])
    dp._replicas_equal(pools, heads)
