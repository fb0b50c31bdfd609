"""fig11's co-residency scenario (``benchmarks/fig11_colocation.py``) on
the port against the reference, at its racecheck shape (4 requests a
tenant, 4 training steps) on the fp32 smoke model.

The port's side is the scenario as ``chip_smoke.py`` restates it for the
card (phase 8: ``co_run`` and its helpers), so the CPU holds that
restatement to the reference.  For hop-only, contention-aware and
serve-only placement: tokens, latencies, handle clocks, engine clocks,
``TrainActor.stats()``, ``link_report``, ``Transport.stats()`` and the
trace events (engines and transport) must be identical to the
reference's, the reference's own ``_run_policy`` must give the same
outcome, fig11's five claims must hold, and both sanitizers must pass
the port's trace with the same report."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from benchmarks import fig11_colocation as fig11              # noqa: E402
from repro import serve as ref_serve                          # noqa: E402
from repro.analysis import sanitize_events as ref_sanitize    # noqa: E402
from repro.analysis.tracediff import diff_events              # noqa: E402
from repro.colo import TrainActor as RefTrainActor            # noqa: E402
from repro.colo import job_routes as ref_job_routes           # noqa: E402
from repro.colo import run_colo as ref_run_colo               # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.configs import get_config as ref_get_config        # noqa: E402
from repro.fabric import Transport as RefTransport            # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import Tracer as RefTracer                     # noqa: E402
from repro.obs import link_report as ref_link_report          # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch.analysis import sanitize_events              # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.obs import Tracer                            # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FULL_CFG = ref_get_config(fig11.ARCH, smoke=False)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only contend with
    the other test workers' (several times slower under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[fig11.ARCH],
                                  compute_dtype="float32")
    cfg = dataclasses.replace(get_config(fig11.ARCH, smoke=True),
                              compute_dtype="float32")
    ref = ref_build(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    params = bridge.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, port, params


def _ref_traced(policy, model, params, traces, bw, n_steps, tracer):
    """fig11's ``_run_policy`` with the engines traced as well as the
    transport (as the smoke traces them), from fig11's own helpers."""
    svc_pods, svc_mems, trn_pods, trn_mems = fig11._place(policy)
    topo = fig11._pricing_topology(fig11._inventory(), bw)
    tx = RefTransport(topo, tracer=tracer)
    cm = ref_serve.ServeCostModel.from_fabric(2.0 * FULL_CFG.param_count())
    cfg = ref_serve.EngineConfig(max_slots=fig11.SLOTS,
                                 max_seq=fig11.PROMPT + fig11.MAX_NEW,
                                 page_size=fig11.PAGE)
    spill = topo.route(f"pod:{svc_pods[0]}", f"mem:{svc_mems[0]}")
    engines = {t: ref_serve.Engine.local(
        model, cfg, params=params,
        budget=ref_serve.KVBudget(fig11.QUOTA, 1e9, fig11.PAGE),
        cost_model=cm, transport=tx, route=spill, tenant=t, tracer=tracer)
        for t in fig11.TENANTS}
    actors = []
    if n_steps > 0:
        actors = [RefTrainActor("job0", fig11._train_breakdown(), tx,
                                ref_job_routes(topo, trn_pods, trn_mems),
                                n_steps=n_steps)]
    res = ref_run_colo([(engines[t], traces[t]) for t in fig11.TENANTS],
                       actors)
    tx.quiesce()
    handles = dict(zip(fig11.TENANTS, res.serve_handles))
    return {"handles": handles, "engines": engines,
            "agg_p95": ref_serve.latency_summary(
                [h for hs in res.serve_handles for h in hs])["p95_s"],
            "p95": {t: ref_serve.latency_summary(handles[t])["p95_s"]
                    for t in fig11.TENANTS},
            "train": res.train[0].stats() if actors else None,
            "placement": {"svc_pods": svc_pods, "train_pods": trn_pods,
                          "train_mem": trn_mems},
            "links": ref_link_report(tx), "transport": tx.stats()}


def _clocks(r):
    return {t: [(h.submit_clock, h.first_token_clock, h.done_clock)
                for h in r["handles"][t]] for t in fig11.TENANTS}


@pytest.fixture(scope="module")
def fig11_runs(models):
    ref, ref_params, port, params = models
    probe = ref_serve.Engine.local(
        ref, ref_serve.EngineConfig(max_slots=fig11.SLOTS,
                                    max_seq=fig11.PROMPT + fig11.MAX_NEW,
                                    page_size=fig11.PAGE),
        params=ref_params,
        budget=ref_serve.KVBudget(fig11.QUOTA, 1e9, fig11.PAGE))
    ref_bw = fig11._page_bw(FULL_CFG, probe.kv.page_bytes)
    bw, page_bytes = cs.co_bw(port, params, torch.device("cpu"))
    assert (bw, page_bytes) == (ref_bw, probe.kv.page_bytes)
    n = cs.CO_RACE_REQUESTS
    ref_traces = {t: ref_serve.burst_trace(
        n, prompt_len=fig11.PROMPT, max_new_tokens=fig11.MAX_NEW,
        vocab=SMOKE_ARCHS[fig11.ARCH].vocab, seed=i)
        for i, t in enumerate(fig11.TENANTS)}
    out = {}
    for name, policy, train in cs.CO_RUNS:
        steps = cs.CO_RACE_STEPS if train else 0
        rt, pt = RefTracer(1 << 18), Tracer(1 << 18)
        out[name] = (_ref_traced(policy, ref, ref_params, ref_traces,
                                 ref_bw, steps, rt),
                     cs.co_run(port, params, torch.device("cpu"), policy,
                               steps, cs.co_traces(n), bw, tracer=pt),
                     rt, pt)
    return out, ref_traces, page_bytes, ref_bw


def test_smoke_constants_restate_fig11():
    assert (cs.CO_PAGE, cs.CO_PROMPT, cs.CO_MAX_NEW, cs.CO_SLOTS,
            cs.CO_QUOTA, cs.CO_TENANTS, cs.CO_BW_SCALE) == \
        (fig11.PAGE, fig11.PROMPT, fig11.MAX_NEW, fig11.SLOTS, fig11.QUOTA,
         fig11.TENANTS, fig11.BW_SCALE)
    assert (cs.CO_PODS, cs.CO_POD_SIZE, cs.CO_MEM, cs.CO_TRAIN_TIER2_GB) == \
        (fig11.N_PODS, fig11.POD_SIZE, fig11.N_MEM, fig11.TRAIN_TIER2_GB)
    par, bd = cs.co_train()
    assert dataclasses.asdict(par) == dataclasses.asdict(fig11.TRAIN_PAR)
    assert dataclasses.asdict(bd) == \
        dataclasses.asdict(fig11._train_breakdown())
    for _, policy, _ in cs.CO_RUNS:
        assert cs.co_place(policy, par.n_gpus) == fig11._place(policy)


def test_smoke_topology_restates_fig11():
    bw = 12345.678
    topo = cs.co_topology(cs.co_inventory(), bw)
    ref_topo = fig11._pricing_topology(fig11._inventory(), bw)
    assert sorted(topo.links) == sorted(ref_topo.links)
    for name, link in topo.links.items():
        ref_link = ref_topo.links[name]
        assert (link.capacity, link.latency) == \
            (ref_link.capacity, ref_link.latency), name


@pytest.mark.parametrize("name", [r[0] for r in cs.CO_RUNS])
def test_fig11_run_equals_reference(fig11_runs, name):
    runs, ref_traces, _, _ = fig11_runs
    ref_r, r, _, _ = runs[name]
    assert [[h.request.prompt_tokens for h in r["handles"][t]]
            for t in fig11.TENANTS] == \
        [[tuple(q.prompt_tokens) for q in ref_traces[t]]
         for t in fig11.TENANTS]
    assert cs.co_outcome(r) == cs.co_outcome(ref_r)
    assert _clocks(r) == _clocks(ref_r)
    assert {t: e.clock for t, e in r["engines"].items()} == \
        {t: e.clock for t, e in ref_r["engines"].items()}
    assert {t: e.stats() for t, e in r["engines"].items()} == \
        {t: e.stats() for t, e in ref_r["engines"].items()}
    assert all(h.done and len(h.tokens) == fig11.MAX_NEW
               for hs in r["handles"].values() for h in hs)


@pytest.mark.parametrize("name", [r[0] for r in cs.CO_RUNS])
def test_fig11_trace_equals_reference_and_sanitizes(fig11_runs, name):
    runs, _, _, _ = fig11_runs
    _, _, rt, pt = runs[name]
    assert pt.dropped == 0 and rt.dropped == 0
    diff = diff_events(rt.events(), pt.events())
    assert diff.identical, diff.format()
    mine, theirs = sanitize_events(pt.events()), ref_sanitize(pt.events())
    assert mine.ok, mine.format()
    assert mine.to_doc() == theirs.to_doc()
    for rule in ("kv-conservation", "link-conservation", "span-serial",
                 "transfer-causality"):
        assert mine.checks[rule] > 0, rule


def test_reference_run_policy_gives_the_same_outcome(models, fig11_runs):
    """The traced restatement is fig11's ``_run_policy``: tracing the
    engines observes, it moves nothing."""
    ref, ref_params = models[:2]
    runs, ref_traces, _, _ = fig11_runs
    got = fig11._run_policy("scalepool", ref, FULL_CFG, ref_params,
                            ref_traces, runs["hop_only"][0]["links"]
                            and fig11._page_bw(
                                FULL_CFG, runs["hop_only"][0]["engines"]
                                ["a"].kv.page_bytes), cs.CO_RACE_STEPS)
    assert cs.co_outcome(got) == cs.co_outcome(runs["hop_only"][1])


def test_fig11_claims_hold_in_the_port(fig11_runs):
    runs, _, page_bytes, _ = fig11_runs
    port = {name: r for name, (_, r, _, _) in runs.items()}
    claims = cs.co_claims(port)
    assert all(claims.values()), claims
    hop = cs.co_modeled(port["hop_only"], page_bytes)
    assert hop["train_pods"] == [0, 1]
    assert cs.co_modeled(port["contention"], page_bytes)["train_pods"] == \
        [2, 3]
    assert hop == cs.co_modeled(runs["hop_only"][0], page_bytes)
    assert cs.co_close(hop, hop, 0.0)
    assert not cs.co_close(hop, {**hop, "agg_p95_s": hop["agg_p95_s"]
                                 * (1 + 1e-8)}, 1e-9)
