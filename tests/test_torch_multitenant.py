"""Multi-tenant pooled serving: the port's ``PoolArbiter`` and
``run_multi_trace`` against the reference's.

First the arbiter's invariants on the port alone, as
``tests/test_multitenant.py`` states them for the reference (a lone
tenant is bit-identical to a private pool, work conservation, revocation
charged to the over-share tenant, page tables that never alias, shares
that cover an indivisible pool, geometry checks).  Then the fig9 smoke
scenario (``benchmarks/fig9_multitenant.py``: three skewed tenants on a
24-page pool, modeled time priced at the full-size model) and fig10's
shared-link runs through both packages: tokens, handle clocks,
per-tenant ``stats()``, ``PoolArbiter.stats()`` and the trace must be
identical, and the port's trace must pass the reference's sanitizer.
Last, the pooled run must be bit-identical under the port's tiebreak
perturbation (the ``racecheck`` contract).

Both models compute in fp32 on the CPU, the port's weights taken from
the reference's ``model.init`` through the bridge."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from benchmarks import fig9_multitenant as fig9               # noqa: E402
from benchmarks import fig10_contention as fig10              # noqa: E402
from repro import serve as ref_serve                          # noqa: E402
from repro.analysis.sanitizer import sanitize_trace_doc       # noqa: E402
from repro.analysis.tracediff import diff_trace_docs          # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.configs import get_config as ref_get_config        # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import Tracer as RefTracer                     # noqa: E402
from repro.obs import to_chrome_trace as ref_chrome           # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch import serve as port_serve                   # noqa: E402
from repro_torch.analysis import tiebreak                     # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.core import fabric as fb                     # noqa: E402
from repro_torch.fabric import Topology, Transport            # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.obs import Tracer, to_chrome_trace           # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, KVBudget,  # noqa: E402
                               PoolArbiter, Request, RequestStatus,
                               ServeCostModel, burst_trace, latency_summary,
                               run_multi_trace, run_trace)

ARCH = "qwen1.5-0.5b"
VOCAB = SMOKE_ARCHS[ARCH].vocab
POOL_PAGES = 6          # tight: forces paging under a heavy trace


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
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    ref = ref_build(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    params = bridge.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, port, params


@pytest.fixture(scope="module")
def model(models):
    return models[2]


@pytest.fixture(scope="module")
def params(models):
    return models[3]


def _cfg(**kw):
    base = dict(max_slots=3, max_seq=64, page_size=8)
    base.update(kw)
    return EngineConfig(**base)


def _engine(model, params, **kw):
    return Engine.local(model, kw.pop("cfg", _cfg()), params=params,
                        device="cpu", **kw)


def _heavy(n=5, seed=0):
    return burst_trace(n, prompt_len=12, max_new_tokens=10, vocab=VOCAB,
                       seed=seed)


def _watch_pages(arb, engines):
    """Check the pool's page conservation and that no two tenants' page
    tables alias a live page at the end of every engine step."""
    steps = [0]
    for eng in engines:
        def step(orig=eng.step):
            dt = orig()
            arb.check_conservation()
            steps[0] += 1
            return dt
        eng.step = step
    return steps


# ---------------------------------------------------------------------------
# single-tenant transparency + work conservation
# ---------------------------------------------------------------------------

def test_lone_tenant_bit_identical_to_private_pool(model, params):
    trace = _heavy()
    priv = _engine(model, params,
                   budget=KVBudget(tier1_pages=POOL_PAGES, tier2_bytes=1e9,
                                   page_size=8))
    h_priv = run_trace(priv, trace)

    arb = PoolArbiter(POOL_PAGES, page_size=8)
    solo = _engine(model, params,
                   budget=KVBudget(tier2_bytes=1e9, page_size=8),
                   arbiter=arb, tenant="solo")
    h_solo = run_trace(solo, trace)

    assert priv.stats()["preempt_swaps"] > 0, "pressure not exercised"
    assert [h.tokens for h in h_priv] == [h.tokens for h in h_solo]
    assert [h.ttft for h in h_priv] == [h.ttft for h in h_solo]
    assert [h.latency for h in h_priv] == [h.latency for h in h_solo]
    for key in ("preempt_swaps", "preempt_recomputes", "steps", "clock_s"):
        assert priv.stats()[key] == solo.stats()[key], key
    assert arb.revoked_pages == 0


def test_work_conservation_lone_tenant_gets_whole_pool(model, params):
    arb = PoolArbiter(POOL_PAGES, page_size=8)
    solo = _engine(model, params, budget=KVBudget(tier2_bytes=1e9,
                                                  page_size=8),
                   arbiter=arb, tenant="solo")
    assert solo.kv.allowance() == POOL_PAGES
    h = solo.submit(Request(tuple(range(1, 13)), 10))
    while not solo.idle:
        solo.step()
        assert solo.kv.allowance() == POOL_PAGES
    assert h.status is RequestStatus.DONE
    # a registered-but-idle second tenant donates its (zero) demand
    _engine(model, params, budget=KVBudget(page_size=8), arbiter=arb,
            tenant="idle")
    h2 = solo.submit(Request(tuple(range(1, 13)), 10))
    while not solo.idle:
        solo.step()
    assert h2.status is RequestStatus.DONE
    assert solo.kv.allowance() == POOL_PAGES


# ---------------------------------------------------------------------------
# revocation: demand-driven, charged to the over-share tenant
# ---------------------------------------------------------------------------

def test_revocation_evicts_over_share_tenant_and_charges_it(model, params):
    arb = PoolArbiter(POOL_PAGES, page_size=8)
    kw = dict(budget=KVBudget(tier2_bytes=1e9, page_size=8), arbiter=arb)
    a = _engine(model, params, tenant="a", **kw)
    b = _engine(model, params, tenant="b", **kw)
    steps = _watch_pages(arb, [a, b])

    trace_a = burst_trace(8, prompt_len=12, max_new_tokens=16,
                          vocab=VOCAB, seed=1)
    trace_b = [dataclasses.replace(r, arrival_time=1e-4)
               for r in burst_trace(2, prompt_len=12, max_new_tokens=4,
                                    vocab=VOCAB, seed=2)]
    ha, hb = run_multi_trace([(a, trace_a), (b, trace_b)])
    assert all(h.status is RequestStatus.DONE for h in ha + hb)
    assert steps[0] > 0

    s = arb.stats()
    assert arb.revoked_pages > 0, "B's arrival never forced revocation"
    charged_a = s["tenants"]["a"]["revocation_charged_s"]
    charged_b = s["tenants"]["b"]["revocation_charged_s"]
    assert charged_a > 0.0
    assert charged_a > 4 * charged_b
    assert sum(h.swaps for h in ha) > 0


def test_tenants_page_tables_never_alias(model, params):
    """Two tenants decoding concurrently over one physical pool never
    hold the same physical page (checked after every step), and their
    tokens match single-tenant runs of the same traces."""
    arb = PoolArbiter(16, page_size=8)
    kw = dict(budget=KVBudget(tier2_bytes=1e9, page_size=8), arbiter=arb)
    a = _engine(model, params, tenant="a", **kw)
    b = _engine(model, params, tenant="b", **kw)
    steps = _watch_pages(arb, [a, b])
    ta, tb = _heavy(n=4, seed=3), _heavy(n=4, seed=4)

    ra = run_trace(_engine(model, params), ta)
    rb = run_trace(_engine(model, params), tb)

    ha, hb = run_multi_trace([(a, ta), (b, tb)])
    assert steps[0] > 0
    assert [h.tokens for h in ha] == [h.tokens for h in ra]
    assert [h.tokens for h in hb] == [h.tokens for h in rb]


def test_page_check_catches_an_aliased_table(model, params):
    """The conservation check the tests and the chip smoke run per step
    fails when a tenant's row points at another tenant's page."""
    arb = PoolArbiter(16, page_size=8)
    kw = dict(budget=KVBudget(tier2_bytes=1e9, page_size=8), arbiter=arb)
    a = _engine(model, params, tenant="a", **kw)
    b = _engine(model, params, tenant="b", **kw)
    a.submit(Request(tuple(range(1, 13)), 10))
    b.submit(Request(tuple(range(2, 14)), 10))
    a.step()
    b.step()
    arb.check_conservation()
    slot = next(i for i, s in enumerate(b._slots) if s is not None)
    b._table[slot, 0] = a._table[0, 0]
    with pytest.raises(AssertionError):
        arb.check_conservation()


def test_sharing_incentive_and_pooling_beats_static(model, params):
    pool_pages, t2 = 12, 1e9
    heavy = burst_trace(6, prompt_len=12, max_new_tokens=12, vocab=VOCAB,
                        seed=5)
    light = [dataclasses.replace(r, arrival_time=1e-4)
             for r in burst_trace(2, prompt_len=12, max_new_tokens=6,
                                  vocab=VOCAB, seed=6)]

    def static_run(trace):
        eng = _engine(model, params,
                      budget=KVBudget(tier1_pages=pool_pages // 2,
                                      tier2_bytes=t2 / 2, page_size=8))
        return run_trace(eng, trace)

    s_heavy, s_light = static_run(heavy), static_run(light)

    arb = PoolArbiter(pool_pages, page_size=8)
    kw = dict(budget=KVBudget(tier2_bytes=t2 / 2, page_size=8), arbiter=arb)
    a = _engine(model, params, tenant="heavy", **kw)
    b = _engine(model, params, tenant="light", **kw)
    f_heavy, f_light = run_multi_trace([(a, heavy), (b, light)])

    agg_static = latency_summary(s_heavy + s_light)["p95_s"]
    agg_fair = latency_summary(f_heavy + f_light)["p95_s"]
    assert agg_fair < agg_static, \
        f"pooling p95 {agg_fair} not better than static {agg_static}"
    p_light_static = latency_summary(s_light)["p95_s"]
    p_light_fair = latency_summary(f_light)["p95_s"]
    assert p_light_fair <= p_light_static * 1.05, \
        f"light tenant p95 {p_light_fair} vs static {p_light_static}"


def test_shares_cover_indivisible_pool(model, params):
    def saturated_arbiter(pages):
        arb = PoolArbiter(pages, page_size=8)
        for t in ("a", "b", "c"):
            eng = _engine(model, params, budget=KVBudget(page_size=8),
                          arbiter=arb, tenant=t)
            eng.submit(Request(tuple(range(1, 21)), 8))
        return arb

    shares = saturated_arbiter(8)._shares()
    assert sum(shares.values()) == 8
    assert sorted(shares.values()) == [2, 3, 3]
    tiny = saturated_arbiter(2)._shares()
    assert sum(tiny.values()) == 2
    assert sorted(tiny.values()) == [0, 1, 1]


def test_arbiter_rejects_mismatched_geometry(model, params):
    arb = PoolArbiter(8, page_size=8)
    _engine(model, params, arbiter=arb, tenant="a")
    assert arb.pool["k"].shape[1] == 9            # 8 pages + the trash
    assert arb.pool["k"].device.type == "cpu"
    with pytest.raises(ValueError, match="page_size"):
        _engine(model, params, cfg=_cfg(page_size=16), arbiter=arb,
                tenant="b")
    with pytest.raises(ValueError, match="already registered"):
        _engine(model, params, arbiter=arb, tenant="a")
    with pytest.raises(ValueError, match="cache geometry"):
        _engine(model, params, cfg=_cfg(cache_dtype="bfloat16"),
                arbiter=arb, tenant="c")
    with pytest.raises(ValueError, match="together"):
        _engine(model, params, transport=Transport(Topology("t")))


def test_arbiter_stats_match_reference_after_scripted_steps(models):
    """Registration, shares, allowances and both stats dicts agree with
    the reference's step by step on a two-tenant burst."""
    ref, ref_params, port, params = models
    out = []
    for S, m, p, kw in ((ref_serve, ref, ref_params, {}),
                        (port_serve, port, params, {"device": "cpu"})):
        arb = S.PoolArbiter(POOL_PAGES, page_size=8)
        engs = [S.Engine.local(m, S.EngineConfig(max_slots=3, max_seq=64,
                                                 page_size=8),
                               params=p, arbiter=arb, tenant=t,
                               budget=S.KVBudget(tier2_bytes=1e9,
                                                 page_size=8), **kw)
                for t in ("x", "y")]
        for i, e in enumerate(engs):
            for r in S.burst_trace(3, prompt_len=12, max_new_tokens=10,
                                   vocab=VOCAB, seed=10 + i):
                e.submit(r)
        snaps = []
        for _ in range(12):
            for e in engs:
                e.step()
                snaps.append((arb.stats(), e.stats(), arb._shares()))
        out.append(snaps)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# fig9 smoke: the port against the reference
# ---------------------------------------------------------------------------

FULL_CFG = ref_get_config(fig9.ARCH, smoke=False)


def _fig9_cost(engine):
    """fig9's cost model, from the reference's own ``_cost_model``."""
    cm = fig9._cost_model(FULL_CFG, engine)
    return ServeCostModel(**dataclasses.asdict(cm))


def _fig9_pooled(S, model, params, traffic, tracer, **kw):
    """fig9's fair-share pooled run with ``S`` (either serve package)."""
    arb = S.PoolArbiter(fig9.POOL_PAGES, page_size=fig9.PAGE, tracer=tracer)
    engines = {}
    for name in fig9.TENANTS:
        eng = S.Engine.local(
            model, S.EngineConfig(**dataclasses.asdict(fig9._ecfg())), params=params,
            budget=S.KVBudget(tier2_bytes=fig9.KV_T2_BYTES
                              / len(fig9.TENANTS), page_size=fig9.PAGE),
            arbiter=arb, tenant=name, tracer=tracer, **kw)
        eng.cost = (fig9._cost_model(FULL_CFG, eng) if S is ref_serve
                    else _fig9_cost(eng))
        engines[name] = eng
    if S is not ref_serve:
        _watch_pages(arb, engines.values())
    lists = S.run_multi_trace([(engines[n], traffic[n])
                               for n in fig9.TENANTS])
    return arb, engines, dict(zip(fig9.TENANTS, lists))


def _port_traffic(traffic):
    return {n: [Request(r.prompt_tokens, r.max_new_tokens, r.arrival_time)
                for r in rs] for n, rs in traffic.items()}


@pytest.fixture(scope="module")
def fig9_runs(models):
    ref, ref_params, port, params = models
    traffic = fig9._traffic(True, VOCAB)
    ref_tracer, tracer = RefTracer(1 << 18), Tracer(1 << 18)
    ref_run = _fig9_pooled(ref_serve, ref, ref_params, traffic, ref_tracer)
    port_run = _fig9_pooled(port_serve,
                            port, params, _port_traffic(traffic), tracer,
                            device="cpu")
    return ref_run, port_run, ref_tracer, tracer


def _same_handles(handles, ref_handles):
    assert len(handles) == len(ref_handles)
    for h, rh in zip(handles, ref_handles):
        assert h.tokens == rh.tokens, h.rid
        assert (h.submit_clock, h.first_token_clock, h.done_clock) == \
            (rh.submit_clock, rh.first_token_clock, rh.done_clock), h.rid
        assert (h.status.value, h.preempts, h.swaps, h.recomputes) == \
            (rh.status.value, rh.preempts, rh.swaps, rh.recomputes), h.rid


def test_fig9_pooled_run_matches_reference(fig9_runs):
    (ref_arb, ref_engines, ref_handles), (arb, engines, handles), _, _ = \
        fig9_runs
    for name in fig9.TENANTS:
        _same_handles(handles[name], ref_handles[name])
        assert engines[name].stats() == ref_engines[name].stats(), name
        assert all(h.status is RequestStatus.DONE for h in handles[name])
    assert arb.stats() == ref_arb.stats()
    assert arb.revoked_pages > 0 and arb.revoked_pages == \
        ref_arb.revoked_pages


def test_fig9_pooled_trace_matches_reference_and_sanitizes(fig9_runs):
    _, _, ref_tracer, tracer = fig9_runs
    assert tracer.dropped == 0 and ref_tracer.dropped == 0
    doc, ref_doc = to_chrome_trace(tracer), ref_chrome(ref_tracer)
    diff = diff_trace_docs(ref_doc, doc)
    assert diff.identical, diff.format()
    names = {e.name for e in tracer.events()}
    assert {"pool_tenants", "revoke", "charge"} <= names
    report = sanitize_trace_doc(doc)
    assert report.ok, report.format()


def test_fig9_claims_hold_in_the_port(model, params, fig9_runs):
    """fig9's four claims, through the port: pooling beats static 1/N
    partitions on aggregate p95, no tenant is worse than 1.05x its static
    p95, revocation fired, and a lone tenant under an arbiter is
    bit-identical to a private engine with the same tight budget."""
    _, (arb, _, fair), _, _ = fig9_runs
    traffic = _port_traffic(fig9._traffic(True, VOCAB))
    n = len(fig9.TENANTS)
    tight = dict(tier1_pages=fig9.POOL_PAGES // n,
                 tier2_bytes=fig9.KV_T2_BYTES / n, page_size=fig9.PAGE)
    static = {}
    for name in fig9.TENANTS:
        eng = _engine(model, params, cfg=EngineConfig(**dataclasses.asdict(fig9._ecfg())),
                      budget=KVBudget(**tight))
        eng.cost = _fig9_cost(eng)
        static[name] = run_trace(eng, traffic[name])
    agg = lambda hs: latency_summary([h for v in hs.values() for h in v])
    assert agg(fair)["p95_s"] < agg(static)["p95_s"]
    for name in fig9.TENANTS:
        assert latency_summary(fair[name])["p95_s"] <= \
            1.05 * latency_summary(static[name])["p95_s"], name
    assert arb.revoked_pages > 0

    priv = _engine(model, params, cfg=EngineConfig(**dataclasses.asdict(fig9._ecfg())),
                   budget=KVBudget(**tight))
    priv.cost = _fig9_cost(priv)
    h_priv = run_trace(priv, traffic["hog"])
    solo_arb = PoolArbiter(fig9.POOL_PAGES // n, page_size=fig9.PAGE)
    solo = _engine(model, params, cfg=EngineConfig(**dataclasses.asdict(fig9._ecfg())),
                   budget=KVBudget(tier2_bytes=fig9.KV_T2_BYTES / n,
                                   page_size=fig9.PAGE),
                   arbiter=solo_arb, tenant="solo")
    solo.cost = _fig9_cost(solo)
    h_solo = run_trace(solo, traffic["hog"])
    assert [h.tokens for h in h_priv] == [h.tokens for h in h_solo]
    assert [(h.first_token_clock, h.done_clock) for h in h_priv] == \
        [(h.first_token_clock, h.done_clock) for h in h_solo]


def _pooled_outcome(model, params):
    tracer = Tracer(1 << 18)
    traffic = _port_traffic(fig9._traffic(True, VOCAB))
    arb, engines, handles = _fig9_pooled(
        port_serve, model, params,
        traffic, tracer, device="cpu")
    outcome = {
        "tokens": {t: [list(h.tokens) for h in handles[t]]
                   for t in fig9.TENANTS},
        "clocks": {t: [(h.first_token_clock, h.done_clock)
                       for h in handles[t]] for t in fig9.TENANTS},
        "engine_clock": {t: engines[t].clock for t in fig9.TENANTS},
        "stats": {t: engines[t].stats() for t in fig9.TENANTS},
        "arbiter": arb.stats(),
    }
    assert tracer.dropped == 0
    return outcome, list(tracer.events())


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_pooled_run_bit_identical_under_tiebreak_perturbation(
        model, params, seed):
    base, base_events = _pooled_outcome(model, params)
    with tiebreak.perturb(seed):
        got, events = _pooled_outcome(model, params)
    assert got == base
    assert events == base_events


# ---------------------------------------------------------------------------
# fig10: tenants on one shared routed fabric
# ---------------------------------------------------------------------------

def _port_topology(ref_topo, ref_routes):
    """The port's copy of a reference ``fabric.Topology``: the same nodes
    and directed links, in the same order, and the same routes."""
    topo = Topology(ref_topo.name)
    for node, kind in ref_topo.nodes.items():
        topo.add_node(node, kind)
    for link in ref_topo.links.values():
        spec = dataclasses.replace(
            getattr(fb, {"CXL 3.x x16": "CXL3",
                         "CXL capacity-oriented": "CXL_CAPACITY"}
                    [link.spec.name]))
        topo.add_link(link.src, link.dst, spec, capacity=link.capacity,
                      latency=link.latency, name=link.name)
    routes = {t: topo.route(r.links[0].src, r.links[-1].dst)
              for t, r in ref_routes.items()}
    for t, r in routes.items():
        assert [l.name for l in r.links] == \
            [l.name for l in ref_routes[t].links]
    return topo, routes


@pytest.fixture(scope="module")
def fig10_bw(models):
    ref, ref_params = models[:2]
    probe = ref_serve.Engine.local(
        ref, ref_serve.EngineConfig(max_slots=fig10.SLOTS,
                                    max_seq=fig10.PROMPT + fig10.MAX_NEW,
                                    page_size=fig10.PAGE),
        params=ref_params,
        budget=ref_serve.KVBudget(fig10.QUOTA, 1e9, fig10.PAGE))
    return fig10._page_bw(FULL_CFG, probe.kv.page_bytes)


@pytest.mark.parametrize("kind", ["shared", "isolated", "hierarchical"])
def test_fig10_topologies_match_reference(models, fig10_bw, kind):
    ref, ref_params, port, params = models
    traces = {t: burst_trace(4, prompt_len=fig10.PROMPT,
                             max_new_tokens=fig10.MAX_NEW, vocab=VOCAB,
                             seed=i)
              for i, t in enumerate(fig10.TENANTS)}
    ref_r = fig10._run_topology(kind, ref, FULL_CFG, ref_params,
                                {t: [ref_serve.Request(r.prompt_tokens,
                                                       r.max_new_tokens,
                                                       r.arrival_time)
                                     for r in tr]
                                 for t, tr in traces.items()}, fig10_bw)

    ref_topo, ref_routes = fig10._topology(kind, fig10_bw)
    topo, routes = _port_topology(ref_topo, ref_routes)
    tx = Transport(topo)
    cm = ServeCostModel.from_fabric(2.0 * FULL_CFG.param_count())
    cfg = EngineConfig(max_slots=fig10.SLOTS,
                       max_seq=fig10.PROMPT + fig10.MAX_NEW,
                       page_size=fig10.PAGE)
    engines = {t: _engine(port, params, cfg=cfg,
                          budget=KVBudget(fig10.QUOTA, 1e9, fig10.PAGE),
                          cost_model=cm, transport=tx, route=routes[t],
                          tenant=t)
               for t in fig10.TENANTS}
    lists = run_multi_trace([(engines[t], traces[t])
                             for t in fig10.TENANTS])
    for t, hs in zip(fig10.TENANTS, lists):
        _same_handles(hs, ref_r["handles"][t])
    assert sum(engines[t].stats()["preempt_swaps"]
               for t in fig10.TENANTS) > 0
    assert {t: engines[t].stats()["preempt_swaps"]
            for t in fig10.TENANTS} == ref_r["swaps"]
    assert tx.stats() == ref_r["transport"]
    if kind == "shared":
        assert tx.stats()["contended_transfers"] > 0
