"""The port's pool scheduler (``repro_torch.pool.scheduler``) against the
reference's.

Each scenario is one function of a package namespace, run once on the
reference and once on the port: fig8's three traces
(``benchmarks/fig8_composability.py``, restated) under ``baseline``
and ``scalepool``, and the DRF, gang, preemption, elastic, tier-2
bandwidth and trunk-admission scenarios of ``tests/test_pool.py``.
``ScheduleResult.summary()``, every ``JobRecord``, the text log and
the ``pool:sched`` trace events must be identical (the reference's
``diff_events`` empty), both sanitizers must pass the port's trace
with the same report, and the port's racecheck must hold the port's
runs bit-identical under the port's ``tiebreak.perturb(1..4)``."""

import dataclasses
import types

import pytest

from repro.analysis import sanitize_events as ref_sanitize
from repro.analysis.tracediff import diff_events as ref_diff_events
from repro.core import simulator as ref_sim
from repro.obs import Tracer as RefTracer
from repro.pool import PoolJob as RefPoolJob
from repro.pool import Scheduler as RefScheduler
from repro.pool import build_inventory as ref_build_inventory
from repro.pool import offload_bw as ref_offload_bw
from repro.pool import offload_bytes as ref_offload_bytes
from repro_torch.analysis import racecheck, sanitize_events
from repro_torch.core import simulator as sim
from repro_torch.obs import Tracer
from repro_torch.pool import (PoolJob, Scheduler, build_inventory,
                              offload_bw, offload_bytes)

GB = 1e9

REF = types.SimpleNamespace(sim=ref_sim, PoolJob=RefPoolJob,
                            Scheduler=RefScheduler,
                            build_inventory=ref_build_inventory,
                            offload_bytes=ref_offload_bytes,
                            offload_bw=ref_offload_bw)
PORT = types.SimpleNamespace(sim=sim, PoolJob=PoolJob, Scheduler=Scheduler,
                             build_inventory=build_inventory,
                             offload_bytes=offload_bytes,
                             offload_bw=offload_bw)


# ---------------------------------------------------------------------------
# fig8's traces, restated over a package
# ---------------------------------------------------------------------------

FIG8_PODS, FIG8_MEM_NODES, FIG8_MEM_GB = 8, 8, 4096.0


def _fig8_job(p, name, model, tp, pp, dp, batch, steps, t, *, offload=True,
              **kw):
    calib = p.sim.Calibration()
    par = p.sim.ParallelismConfig(tp=tp, pp=pp, dp=dp,
                                  global_batch_seqs=batch)
    t2 = p.offload_bytes(model, calib) if offload else 0.0
    return p.PoolJob(name, model, par, n_steps=steps, tier2_bytes=t2,
                     submit_t=t, **kw)


def _steady_mix(p):
    s = p.sim
    return [
        _fig8_job(p, "meg-0", s.MEGATRON, 8, 1, 8, 512, 60, 0.0,
                  offload=False),
        _fig8_job(p, "gpt3-0", s.GPT3, 8, 8, 2, 256, 30, 0.0),
        _fig8_job(p, "llama-0", s.LLAMA3, 8, 8, 2, 256, 20, 5.0),
        _fig8_job(p, "meg-1", s.MEGATRON, 8, 1, 8, 512, 60, 10.0,
                  offload=False),
        _fig8_job(p, "gpt3-1", s.GPT3, 8, 8, 2, 256, 30, 15.0),
    ]


def _burst(p):
    return [_fig8_job(p, f"gopher-{i}", p.sim.GOPHER, 8, 4, 2, 256, 25, 0.0)
            for i in range(6)]


def _elastic_churn(p):
    s = p.sim
    return [
        _fig8_job(p, "bg-0", s.MEGATRON, 8, 1, 16, 512, 80, 0.0,
                  offload=False, elastic=True, min_dp=4),
        _fig8_job(p, "bg-1", s.GOPHER, 8, 4, 2, 256, 40, 0.0, elastic=True,
                  min_dp=1),
        _fig8_job(p, "bg-2", s.GPT3, 8, 8, 2, 256, 25, 2.0),
        _fig8_job(p, "fg-hi", s.LLAMA3, 8, 8, 2, 256, 10, 8.0, priority=1),
    ]


FIG8 = {"steady_mix": _steady_mix, "burst": _burst,
        "elastic_churn": _elastic_churn}


def _fig8(trace, policy):
    def scenario(p, tracer):
        calib = p.sim.Calibration()
        inv = p.build_inventory(
            n_pods=FIG8_PODS, pod_size=calib.cluster_size,
            hbm_per_accel_gb=calib.hbm_per_gpu_gb,
            n_memory_nodes=FIG8_MEM_NODES if policy == "scalepool" else 0,
            memory_node_gb=FIG8_MEM_GB, interconnect=policy)
        sched = p.Scheduler(inv, policy, calib=calib, tracer=tracer)
        for job in FIG8[trace](p):
            sched.submit(job)
        return sched, sched.run()
    return scenario


# ---------------------------------------------------------------------------
# tests/test_pool.py's scheduler scenarios, over a package
# ---------------------------------------------------------------------------

def _small_inventory(p, policy="scalepool", **kw):
    base = dict(n_pods=4, pod_size=8, hbm_per_accel_gb=192.0,
                n_memory_nodes=2 if policy == "scalepool" else 0,
                memory_node_gb=1024.0, interconnect=policy)
    base.update(kw)
    return p.build_inventory(**base)


def _par(p, dp, tp=2, batch=64):
    return p.sim.ParallelismConfig(tp=tp, pp=1, dp=dp,
                                   global_batch_seqs=batch)


def _end_to_end(policy):
    """Preemption by a priority job, an elastic job admitted shrunk that
    grows back, tier-2 offload reservations."""
    def scenario(p, tracer):
        calib = dataclasses.replace(p.sim.Calibration(), cluster_size=8)
        t2 = p.offload_bytes(p.sim.MEGATRON, calib)
        sched = p.Scheduler(_small_inventory(p, policy), policy,
                            tracer=tracer)
        m = p.sim.MEGATRON
        for job in (
                p.PoolJob("a", m, _par(p, 4), n_steps=50, tier2_bytes=t2),
                p.PoolJob("b", m, _par(p, 2), n_steps=50),
                p.PoolJob("c", m, _par(p, 8), n_steps=80, tier2_bytes=t2,
                          submit_t=1.0, elastic=True, min_dp=2),
                p.PoolJob("hi", m, _par(p, 4), n_steps=30, submit_t=2.0,
                          priority=1)):
            sched.submit(job)
        return sched, sched.run()
    return scenario


def _drf_gang(user):
    """DRF queueing, a gang declared with gang_size whose members arrive
    one second apart (with and without an explicit user)."""
    def scenario(p, tracer):
        sched = p.Scheduler(_small_inventory(p), queueing="drf",
                            tracer=tracer)
        for i, t in enumerate([0.0, 1.0]):
            sched.submit(p.PoolJob(f"g{i}", p.sim.MEGATRON,
                                   _par(p, 3, batch=66), n_steps=10,
                                   submit_t=t, gang="pair", gang_size=2,
                                   **({"user": user} if user else {})))
        sched.submit(p.PoolJob("solo", p.sim.MEGATRON, _par(p, 2, batch=66),
                               n_steps=5, submit_t=0.5, user="v"))
        sched.submit(p.PoolJob("el", p.sim.MEGATRON, _par(p, 4, batch=66),
                               n_steps=6, submit_t=0.5, user="w",
                               elastic=True, min_dp=1))
        return sched, sched.run()
    return scenario


def _incomplete_gang(p, tracer):
    sched = p.Scheduler(_small_inventory(p), queueing="drf", tracer=tracer)
    sched.submit(p.PoolJob("lone", p.sim.MEGATRON, _par(p, 3, batch=66),
                           n_steps=10, gang="pair", gang_size=2))
    return sched, sched.run()


def _preempt_spares_gang(p, tracer):
    sched = p.Scheduler(_small_inventory(p), tracer=tracer)
    for i in range(2):
        sched.submit(p.PoolJob(f"g{i}", p.sim.MEGATRON, _par(p, 6),
                               n_steps=30, user="u", gang="pair",
                               gang_size=2))
    sched.submit(p.PoolJob("hi", p.sim.MEGATRON, _par(p, 8), n_steps=5,
                           submit_t=1.0, priority=1))
    return sched, sched.run()


def _fifo_gang(p, tracer):
    sched = p.Scheduler(_small_inventory(p), tracer=tracer)
    for i, t in enumerate([0.0, 2.0]):
        sched.submit(p.PoolJob(f"g{i}", p.sim.MEGATRON, _par(p, 3, batch=66),
                               n_steps=10, submit_t=t, gang="pair",
                               gang_size=2, user="u"))
    return sched, sched.run()


def _memory_burst(policy):
    """Four 450 GB jobs at t=0: more than a pod's idle HBM under
    baseline, within the tier-2 pool under scalepool."""
    def scenario(p, tracer):
        calib = dataclasses.replace(p.sim.Calibration(), cluster_size=8)
        sched = p.Scheduler(_small_inventory(p, policy), policy,
                            calib=calib, tracer=tracer)
        for i in range(4):
            sched.submit(p.PoolJob(f"j{i}", p.sim.MEGATRON,
                                   _par(p, 3, batch=66), n_steps=40,
                                   tier2_bytes=450 * GB))
        return sched, sched.run()
    return scenario


def _tier2_bandwidth(p, tracer):
    """Two offload-heavy jobs oversubscribing the per-node bandwidth."""
    inv = _small_inventory(p, memory_node_gb=4096.0, memory_node_gbps=40.0)
    sched = p.Scheduler(inv, tracer=tracer)
    for i in range(2):
        sched.submit(p.PoolJob(f"offl-{i}", p.sim.MEGATRON, _par(p, 2),
                               n_steps=5, tier2_bytes=256 * GB,
                               tier2_bw=60 * GB))
    return sched, sched.run()


def _trunk_admission(p, tracer):
    """Demands that fit the memory nodes but not the shared 50 GB/s
    spine->t2sw trunk: the second job waits for the first; a third,
    light job (its bandwidth from ``offload_bw``) fits beside it."""
    inv = _small_inventory(p, memory_node_gbps=40.0, tier2_trunk_gbps=50.0)
    sched = p.Scheduler(inv, tracer=tracer)
    light = p.offload_bw(p.sim.MEGATRON, p.sim.Calibration(), 0.05)
    for name, bw in (("fits", 30 * GB), ("late", 30 * GB), ("light", light)):
        sched.submit(p.PoolJob(name, p.sim.MEGATRON, _par(p, 2), n_steps=5,
                               tier2_bytes=64 * GB, tier2_bw=bw))
    return sched, sched.run()


def _partial_horizon(p, tracer):
    """run(until=...) with a job straddling the horizon, then resumed."""
    sched = p.Scheduler(_small_inventory(p), tracer=tracer)
    sched.submit(p.PoolJob("j", p.sim.MEGATRON, _par(p, 2), n_steps=50))
    sched.run(until=7.0)
    return sched, sched.run()


SCENARIOS = {
    **{f"fig8-{t}-{pol}": _fig8(t, pol) for t in FIG8
       for pol in ("baseline", "scalepool")},
    "end_to_end-baseline": _end_to_end("baseline"),
    "end_to_end-scalepool": _end_to_end("scalepool"),
    "drf-gang-user": _drf_gang("u"),
    "drf-gang-no-user": _drf_gang(None),
    "incomplete-gang": _incomplete_gang,
    "preempt-spares-gang": _preempt_spares_gang,
    "fifo-gang": _fifo_gang,
    "memory-burst-baseline": _memory_burst("baseline"),
    "memory-burst-scalepool": _memory_burst("scalepool"),
    "tier2-bandwidth": _tier2_bandwidth,
    "trunk-admission": _trunk_admission,
    "partial-horizon": _partial_horizon,
}


def _outcome(res):
    return {"summary": res.summary(),
            "records": {n: dataclasses.asdict(r)
                        for n, r in sorted(res.records.items())},
            "trace": list(res.trace),
            "areas": (res.makespan, res.util_area, res.granted_area,
                      list(res.frag_samples), res.total_accels)}


@pytest.fixture(scope="module")
def runs():
    """Every scenario on both packages, traced."""
    out = {}
    for name, scenario in SCENARIOS.items():
        rt, pt = RefTracer(1 << 18), Tracer(1 << 18)
        _, ref_res = scenario(REF, rt)
        sched, res = scenario(PORT, pt)
        assert rt.dropped == 0 and pt.dropped == 0
        out[name] = (ref_res, res, rt, pt, sched)
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_schedule_equals_reference(runs, name):
    ref_res, res, _, _, _ = runs[name]
    assert _outcome(res) == _outcome(ref_res)
    assert (res.utilization, res.stranded_frac, res.mean_jct,
            res.mean_queue_delay, res.mean_fragmentation) == \
        (ref_res.utilization, ref_res.stranded_frac, ref_res.mean_jct,
         ref_res.mean_queue_delay, ref_res.mean_fragmentation)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sched_trace_equals_reference_and_sanitizes(runs, name):
    _, _, rt, pt, _ = runs[name]
    events = pt.events()
    assert any(e.track == "pool:sched" for e in events)
    diff = ref_diff_events(rt.events(), events)
    assert diff.identical, diff.format()
    mine, theirs = sanitize_events(events), ref_sanitize(events)
    assert mine.ok, mine.format()
    assert mine.to_doc() == theirs.to_doc()
    assert mine.checks["sched-job-span"] > 0
    assert mine.checks["sched-accel-conservation"] > 0


def test_fig8_claim_holds_in_the_port(runs):
    """Pooling beats static partitioning on utilization AND mean JCT on
    at least one of fig8's traces."""
    wins = {}
    for t in FIG8:
        base = runs[f"fig8-{t}-baseline"][1].summary()
        sp = runs[f"fig8-{t}-scalepool"][1].summary()
        wins[t] = (sp["utilization"] > base["utilization"]
                   and sp["mean_jct"] < base["mean_jct"])
    assert any(wins.values()), wins


def test_end_to_end_semantics_in_the_port(runs):
    res = runs["end_to_end-scalepool"][1]
    recs = res.records
    assert all(r.finish_t is not None and r.start_t >= r.submit_t
               for r in recs.values())
    assert recs["hi"].queue_delay == pytest.approx(0.0)
    assert any("preempt" in line for line in res.trace)
    assert any("grow c" in line for line in res.trace)
    assert recs["c"].dp_granted == 8 and recs["c"].resizes >= 1
    assert 0.0 < res.utilization <= 1.0
    assert res.util_area <= res.granted_area + 1e-9
    assert res.summary()["n_finished"] == 4


def test_gangs_in_the_port(runs):
    for name in ("drf-gang-user", "drf-gang-no-user"):
        res, sched = runs[name][1], runs[name][4]
        recs = res.records
        assert all(r.finish_t is not None for r in recs.values())
        assert recs["g0"].start_t == pytest.approx(1.0)
        assert recs["g0"].start_t == pytest.approx(recs["g1"].start_t)
        assert any("hold g0" in line for line in res.trace)
        assert any("admit gang 'pair'" in line for line in res.trace)
        assert not sched._pending_gangs
    lone = runs["incomplete-gang"][1]
    assert lone.records["lone"].start_t is None
    assert any("WARNING gang 'pair' incomplete" in l for l in lone.trace)
    fifo = runs["fifo-gang"][1].records
    assert fifo["g0"].start_t == pytest.approx(2.0) == fifo["g1"].start_t
    spared = runs["preempt-spares-gang"][1].records
    assert spared["g0"].preemptions == 0 == spared["g1"].preemptions
    assert spared["hi"].start_t >= min(spared["g0"].finish_t,
                                       spared["g1"].finish_t)


def test_mixed_gang_sizes_are_an_error_in_the_port():
    sched = Scheduler(_small_inventory(PORT), queueing="drf")
    par = _par(PORT, 3, batch=66)
    sched.submit(PoolJob("m1", sim.MEGATRON, par, n_steps=10, gang="pair",
                         gang_size=2))
    sched.submit(PoolJob("m2", sim.MEGATRON, par, n_steps=10, gang="pair",
                         gang_size=3))
    with pytest.raises(ValueError, match="gang_size"):
        sched.run()
    with pytest.raises(ValueError, match="queueing"):
        Scheduler(_small_inventory(PORT), queueing="lottery")


def test_memory_and_bandwidth_in_the_port(runs):
    base = runs["memory-burst-baseline"][1]
    sp = runs["memory-burst-scalepool"][1]
    assert sp.utilization > base.utilization and sp.mean_jct < base.mean_jct
    assert sp.stranded_frac == pytest.approx(0.0)
    assert base.stranded_frac > 0.0
    for name, first, second in (("tier2-bandwidth", "offl-0", "offl-1"),
                                ("trunk-admission", "fits", "late")):
        recs = runs[name][1].records
        assert all(r.finish_t is not None for r in recs.values())
        assert recs[second].start_t >= recs[first].finish_t, name
    trunk = runs["trunk-admission"][1].records
    assert trunk["light"].start_t == pytest.approx(0.0)


def test_partial_horizon_in_the_port():
    def fresh():
        s = Scheduler(_small_inventory(PORT))
        s.submit(PoolJob("j", sim.MEGATRON, _par(PORT, 2), n_steps=50))
        return s
    full = fresh().run()
    T = full.records["j"].finish_t
    sched = fresh()
    half = sched.run(until=T / 2)
    assert half.records["j"].finish_t is None
    assert half.makespan == pytest.approx(T / 2)
    assert half.util_area == pytest.approx(4 * T / 2)
    rest = sched.run()
    assert rest.records["j"].finish_t == pytest.approx(T)
    assert rest.util_area == pytest.approx(full.util_area)


@pytest.mark.parametrize("name", ["fig8-elastic_churn-scalepool",
                                  "drf-gang-user", "end_to_end-scalepool",
                                  "trunk-admission"])
def test_racecheck_holds_the_port_bit_identical(name):
    def scenario(tracer):
        _, res = SCENARIOS[name](PORT, tracer)
        return _outcome(res)
    rep = racecheck(scenario, seeds=(1, 2, 3, 4), label=name)
    assert rep.ok, rep.format()
    assert rep.baseline_events > 10
