"""Train+serve co-residency: the port's ``repro_torch.colo`` against the
reference's ``repro.colo``, on the fp32 smoke model.

The contracts of ``tests/test_colo.py``, each run through both packages
with the same setup and required equal with ``==``: a training step
priced through a quiet transport is bit-identical to ``simulate_step``
for every fig6 workload; ``run_colo`` with no training is
``run_multi_trace``; a lone training actor under the driver is the
closed form; an interleaved run is deterministic, couples the two
workload classes, and tracing it is passive (its trace identical to the
reference's and clean under both sanitizers); contention-aware placement
reduces to min-hops on an empty estate; per-label link attribution
agrees live and from the trace.  Both models compute in fp32 on the
CPU, the port's weights taken from the reference's ``model.init``
through the bridge."""

import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import colo as ref_colo                            # noqa: E402
from repro import serve as ref_serve                          # noqa: E402
from repro.analysis import sanitize_events as ref_sanitize    # noqa: E402
from repro.analysis.tracediff import diff_events              # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.core import fabric as ref_fb                       # noqa: E402
from repro.core import simulator as ref_sim                   # noqa: E402
from repro.fabric import Topology as RefTopology              # noqa: E402
from repro.fabric import Transport as RefTransport            # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import Tracer as RefTracer                     # noqa: E402
from repro.obs import link_report as ref_link_report          # noqa: E402
from repro.pool import build_inventory as ref_build_inventory  # noqa: E402
from repro.pool.allocator import Allocator as RefAllocator    # noqa: E402
from repro.pool.allocator import JobRequest as RefJobRequest  # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch import colo                                  # noqa: E402
from repro_torch import serve                                 # noqa: E402
from repro_torch.analysis import racecheck, sanitize_events  # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.core import costmodel as cmod                # noqa: E402
from repro_torch.core import fabric as fb                     # noqa: E402
from repro_torch.core import simulator as sim                 # noqa: E402
from repro_torch.fabric import Topology, Transport            # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.obs import (Tracer, link_report,             # noqa: E402
                             link_report_from_trace, to_chrome_trace,
                             validate_trace_events)
from repro_torch.pool import build_inventory                  # noqa: E402
from repro_torch.pool.allocator import Allocator, JobRequest  # noqa: E402

ARCH = "qwen1.5-0.5b"
VOCAB = SMOKE_ARCHS[ARCH].vocab
ROOT = Path(__file__).resolve().parent.parent

REF = types.SimpleNamespace(
    serve=ref_serve, colo=ref_colo, sim=ref_sim, fb=ref_fb,
    Topology=RefTopology, Transport=RefTransport,
    build_inventory=ref_build_inventory, kw={})
PORT = types.SimpleNamespace(
    serve=serve, colo=colo, sim=sim, fb=fb, Topology=Topology,
    Transport=Transport, build_inventory=build_inventory,
    kw={"device": "cpu"})


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
    """{package: (model, params)}: the reference's fp32 smoke model and
    the port's, with the reference's weights carried across."""
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    ref = ref_build(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    params = bridge.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu")
    return {"ref": (ref, ref_params), "port": (port, params)}


def _estate_topo(p):
    return p.build_inventory(
        n_pods=4, pod_size=4, hbm_per_accel_gb=64.0, n_memory_nodes=2,
        memory_node_gb=64.0, interconnect="scalepool").topology()


def _megatron_step(p):
    c = dataclasses.replace(p.sim.Calibration(), cluster_size=4)
    return p.sim.simulate_step(
        p.sim.MEGATRON,
        p.sim.ParallelismConfig(tp=2, pp=1, dp=4, global_batch_seqs=64),
        p.sim.make_system("scalepool", 8, c))


# ---------------------------------------------------------------------------
# routed solo pricing is bit-identical to the closed form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["baseline", "scalepool"])
def test_routed_solo_step_bit_identical_to_simulate_step(kind):
    topo = _estate_topo(PORT)
    for w in sim.FIG6_WORKLOADS:
        c = dataclasses.replace(sim.Calibration(), ib_load=w.ib_load,
                                cxl_load=w.cxl_load)
        bd = sim.simulate_step(w.model, w.par,
                               sim.make_system(kind, w.par.n_gpus, c))
        actor = colo.TrainActor("solo", bd, Transport(topo),
                                colo.job_routes(topo, [0, 1, 2, 3], [0]),
                                n_steps=3)
        assert [actor.step() for _ in range(3)] == [bd.total] * 3
        assert actor.clock == 3 * bd.total and actor.stretch_s == 0.0
        assert [p.name for p in actor.phases] == \
            [p.name for p in ref_colo.plan_phases(
                bd, ref_colo.job_routes(_estate_topo(REF), [0, 1, 2, 3],
                                        [0]))]


def test_routed_pricing_sidesteps_volume_roundtrip_rounding():
    base, lat, bw = 0.3, 0.03, 3.0
    topo = Topology("t")
    topo.add_node("a", "pod")
    topo.add_node("m", "memory")
    topo.connect("a", "m", fb.CXL_CAPACITY, capacity=bw, latency=lat)
    route = topo.route("a", "m")
    vol = cmod.phase_volume(base, route)
    assert vol > 0
    assert route.latency() + vol / route.bottleneck_bw != base
    t = 0.0
    for _ in range(4):
        got = cmod.routed_phase_time(Transport(topo), route, base, t)
        assert got == base
        t += got
    assert colo.plan_phases(sim.StepBreakdown(), {"offload": route}) == ()


# ---------------------------------------------------------------------------
# the driver: degeneracy, determinism, passive tracing
# ---------------------------------------------------------------------------

def _serve_setup(p, model, params, tracer=None):
    """Two tenants spilling KV over one slow shared trunk."""
    S = p.serve
    cm = S.ServeCostModel.from_fabric(2.0 * 1e9)
    topo = p.Topology("t")
    topo.add_node("sw", "switch")
    topo.add_node("mem", "memory")
    bw = 1e5
    for t in ("a", "b"):
        topo.add_node(t, "endpoint")
        topo.connect(t, "sw", p.fb.CXL3, capacity=8 * bw, latency=1e-4)
    topo.connect("sw", "mem", p.fb.CXL_CAPACITY, capacity=bw, latency=1e-4)
    tx = p.Transport(topo, tracer=tracer)
    engines = {t: S.Engine.local(model, S.EngineConfig(max_slots=3,
                                                       max_seq=64,
                                                       page_size=8),
                                 params=params,
                                 budget=S.KVBudget(6, 1e9, 8),
                                 cost_model=cm, transport=tx,
                                 route=topo.route(t, "mem"), tenant=t,
                                 tracer=tracer, **p.kw)
               for t in ("a", "b")}
    traces = {t: S.burst_trace(4, prompt_len=12, max_new_tokens=10,
                               vocab=VOCAB, seed=i)
              for i, t in enumerate(("a", "b"))}
    return engines, traces, tx, topo


def _fingerprint(engines, handle_lists):
    return ([[h.tokens for h in hs] for hs in handle_lists],
            [[(h.submit_clock, h.first_token_clock, h.done_clock)
              for h in hs] for hs in handle_lists],
            [e.clock for e in engines.values()])


def _colo_run(p, model, params, tracer=None):
    engines, traces, tx, topo = _serve_setup(p, model, params, tracer)
    actor = p.colo.TrainActor("job", _megatron_step(p), tx,
                              {"offload": topo.route("a", "mem")}, n_steps=4)
    res = p.colo.run_colo([(engines[t], traces[t]) for t in ("a", "b")],
                          [actor])
    tx.quiesce()
    return engines, actor, res, tx


def test_run_colo_without_training_is_run_multi_trace(models):
    model, params = models["port"]
    e1, tr1, _, _ = _serve_setup(PORT, model, params)
    ref = serve.run_multi_trace([(e1[t], tr1[t]) for t in ("a", "b")])
    e2, tr2, _, _ = _serve_setup(PORT, model, params)
    res = colo.run_colo([(e2[t], tr2[t]) for t in ("a", "b")])
    assert res.train == []
    assert _fingerprint(e1, ref) == _fingerprint(e2, res.serve_handles)
    e3, tr3, _, _ = _serve_setup(REF, *models["ref"])
    got = ref_colo.run_colo([(e3[t], tr3[t]) for t in ("a", "b")])
    assert _fingerprint(e3, got.serve_handles) == \
        _fingerprint(e2, res.serve_handles)


def test_train_only_under_driver_matches_closed_form():
    topo = _estate_topo(PORT)
    bd = _megatron_step(PORT)
    actor = colo.TrainActor("t", bd, Transport(topo),
                            colo.job_routes(topo, [0, 1, 2, 3], [0]),
                            n_steps=5)
    res = colo.run_colo([], [actor])
    assert res.train_stats()["t"]["steps"] == 5
    assert actor.step_times == [bd.total] * 5
    assert actor.clock == 5 * bd.total
    rtopo = _estate_topo(REF)
    ract = ref_colo.TrainActor(
        "t", _megatron_step(REF), RefTransport(rtopo),
        ref_colo.job_routes(rtopo, [0, 1, 2, 3], [0]), n_steps=5)
    assert ref_colo.run_colo([], [ract]).train_stats() == res.train_stats()


@pytest.fixture(scope="module")
def interleaved(models):
    """The interleaved run on both packages, traced, and the port's
    again untraced."""
    rt, pt = RefTracer(1 << 18), Tracer(1 << 18)
    ref_run = _colo_run(REF, *models["ref"], tracer=rt)
    port_run = _colo_run(PORT, *models["port"], tracer=pt)
    bare = _colo_run(PORT, *models["port"])
    return ref_run, port_run, bare, rt, pt


def test_interleaved_run_equals_reference(interleaved):
    (re, ra, rres, rtx), (e, a, res, tx), _, _, _ = interleaved
    assert _fingerprint(e, res.serve_handles) == \
        _fingerprint(re, rres.serve_handles)
    assert a.step_times == ra.step_times and a.clock == ra.clock
    assert a.stats() == ra.stats()
    assert a.stretch_s > 0.0        # the two classes really coupled
    assert tx.stats() == rtx.stats()
    assert link_report(tx) == ref_link_report(rtx)


def test_traced_run_identical_to_untraced_and_reference(interleaved):
    _, (e, a, res, _), (e2, a2, res2, _), rt, pt = interleaved
    assert _fingerprint(e, res.serve_handles) == \
        _fingerprint(e2, res2.serve_handles)
    assert a.step_times == a2.step_times
    assert pt.dropped == 0
    diff = diff_events(rt.events(), pt.events())
    assert diff.identical, diff.format()
    mine, theirs = sanitize_events(pt.events()), ref_sanitize(pt.events())
    assert mine.ok, mine.format()
    assert mine.to_doc() == theirs.to_doc()
    assert mine.checks["link-conservation"] > 0
    assert validate_trace_events(to_chrome_trace(pt)) == []


def test_interleaved_run_bit_deterministic(models, interleaved):
    _, (e, a, res, _), _, _, _ = interleaved
    e3, a3, res3, _ = _colo_run(PORT, *models["port"])
    assert _fingerprint(e, res.serve_handles) == \
        _fingerprint(e3, res3.serve_handles)
    assert a.step_times == a3.step_times


def test_interleaved_run_bit_identical_under_port_perturbation(models):
    """The driver's serve/train selection and the transport's re-rating
    under the port's ``tiebreak.perturb(1..4)``."""
    def scenario(tracer):
        engines, actor, res, tx = _colo_run(PORT, *models["port"], tracer)
        return {"serve": _fingerprint(engines, res.serve_handles),
                "train": actor.stats(), "transport": tx.stats(),
                "links": link_report(tx)}
    rep = racecheck(scenario, seeds=(1, 2, 3, 4), label="colo")
    assert rep.ok, rep.format()
    assert rep.baseline_events > 100


def test_fig11_racecheck_of_the_smoke_passes_on_the_cpu(models):
    """``chip_smoke.py``'s phase-8 racecheck (fig11's hop-only scenario
    at 4 requests a tenant and 4 training steps), run here on the fp32
    smoke model."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rep = cs.co_racecheck(*models["port"], torch.device("cpu"))
    assert rep.ok, rep.format()
    assert rep.seeds == cs.CO_RACE_SEEDS and rep.baseline_events > 1000


# ---------------------------------------------------------------------------
# contention-aware placement, flow labels
# ---------------------------------------------------------------------------

def _fig11_inventory(p):
    inv = p.build_inventory(n_pods=6, pod_size=5, hbm_per_accel_gb=64.0,
                            n_memory_nodes=2, memory_node_gb=64.0,
                            interconnect="scalepool")
    inter = inv.inter_fabric
    inter = dataclasses.replace(
        inter, topology=dataclasses.replace(
            inter.topology, switch=dataclasses.replace(
                inter.topology.switch, radix=4)))
    return dataclasses.replace(inv, inter_fabric=inter)


def test_contention_reduces_to_min_hops_on_empty_estate():
    for args, kw in ((("j", 3), {}), (("k", 8), {"tier2_bytes": 8e9})):
        pods = {}
        for policy in ("scalepool", "contention"):
            alloc = Allocator(_fig11_inventory(PORT), policy).allocate(
                JobRequest(*args, **kw))
            ref = RefAllocator(_fig11_inventory(REF), policy).allocate(
                RefJobRequest(*args, **kw))
            assert alloc is not None and alloc.pod_ids == ref.pod_ids
            pods[policy] = alloc.pod_ids
        assert pods["scalepool"] == pods["contention"]


def _labeled(p, tracer):
    topo = p.Topology("t")
    for n in ("a", "b"):
        topo.add_node(n, "pod")
    topo.add_node("m", "memory")
    topo.connect("a", "m", p.fb.CXL_CAPACITY, capacity=10.0, latency=0.0)
    topo.connect("b", "m", p.fb.CXL_CAPACITY, capacity=10.0, latency=0.0)
    tx = p.Transport(topo, tracer=tracer)
    tx.begin_transfer(topo.route("a", "m"), 40.0, 0.0, label="serve:a")
    tx.begin_transfer(topo.route("b", "m"), 40.0, 1.0, label="train:j")
    tx.begin_transfer(topo.route("a", "m"), 40.0, 2.0)          # unlabeled
    tx.quiesce()
    return tx


def test_link_label_attribution_live_vs_trace():
    tracer = Tracer()
    tx = _labeled(PORT, tracer)
    live = link_report(tx)
    from_trace = link_report_from_trace(to_chrome_trace(tracer))
    for name in live:
        if name in from_trace:
            assert live[name]["by_label"] == \
                pytest.approx(from_trace[name]["by_label"])
        else:
            assert live[name]["by_label"] == {}
    assert live["a->m"]["by_label"] == {"serve:a": 40.0}
    assert live["b->m"]["by_label"] == {"train:j": 40.0}
    for row in live.values():
        assert sum(row["by_label"].values()) <= row["bytes"] + 1e-6
    assert any(e.ph == "X" and "label" not in e.args
               for e in tracer.events())
    rtracer = RefTracer()
    rtx = _labeled(REF, rtracer)
    assert live == ref_link_report(rtx)
    from repro.obs import link_report_from_trace as ref_from_trace
    from repro.obs import to_chrome_trace as ref_chrome
    assert from_trace == ref_from_trace(ref_chrome(rtracer))
    from repro.obs import format_link_report as ref_format
    from repro_torch.obs import format_link_report
    assert format_link_report(live, window_s=3.0) == \
        ref_format(ref_link_report(rtx), window_s=3.0)


def test_engine_emits_kv_counters_when_traced(models):
    model, params = models["port"]
    tracer = Tracer()
    eng = serve.Engine.local(model, serve.EngineConfig(max_slots=3,
                                                       max_seq=64,
                                                       page_size=8),
                             params=params, budget=serve.KVBudget(6, 1e9, 8),
                             tenant="a", tracer=tracer, device="cpu")
    serve.run_trace(eng, serve.burst_trace(3, prompt_len=12,
                                           max_new_tokens=8, vocab=VOCAB,
                                           seed=0))
    names = {e.name for e in tracer.events() if e.ph == "C"}
    assert {"free_pages", "paused", "allowance"} <= names
