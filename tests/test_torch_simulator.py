"""The port's analytical training simulator and collective cost model
(``repro_torch.core.simulator`` / ``costmodel``) against the
reference's.

Both are pure Python copies, so modeled seconds must be equal with
``==``, not close: every ``StepBreakdown`` field of fig6's workloads
on the baseline and scalepool systems (and with the colocation
estate's cluster size), fig6/fig7's rows, and the cost model's
transfer, collective and routed-phase prices over a hypothesis grid.
Then the reference's ``tests/test_simulator.py`` claims (fig6/fig7
bands, the monotonicity properties) hold on the port."""

import dataclasses

import pytest
from _hypothesis_compat import given, settings, st

from repro.core import costmodel as ref_cm
from repro.core import fabric as ref_fb
from repro.core import simulator as ref_sim
from repro.fabric import Topology as RefTopology
from repro.fabric import Transport as RefTransport
from repro_torch.core import costmodel as cm
from repro_torch.core import fabric as fb
from repro_torch.core import simulator as sim
from repro_torch.fabric import Topology, Transport

KINDS = ("baseline", "scalepool")


def _pair(ref_obj, port_cls):
    """A reference dataclass restated as the port's (same fields)."""
    return port_cls(**{f.name: getattr(ref_obj, f.name)
                       for f in dataclasses.fields(ref_obj)})


def _calibs():
    """The default calibration, fig6's per-workload loads, and the
    colocation estate's 5-accel clusters."""
    out = [("default", ref_sim.Calibration(), sim.Calibration())]
    for w in ref_sim.FIG6_WORKLOADS:
        out.append((f"{w.model.name}-load",
                    dataclasses.replace(ref_sim.Calibration(),
                                        ib_load=w.ib_load,
                                        cxl_load=w.cxl_load),
                    dataclasses.replace(sim.Calibration(),
                                        ib_load=w.ib_load,
                                        cxl_load=w.cxl_load)))
    out.append(("cluster5",
                dataclasses.replace(ref_sim.Calibration(), cluster_size=5),
                dataclasses.replace(sim.Calibration(), cluster_size=5)))
    return out


# ---------------------------------------------------------------------------
# simulate_step / fig6 / fig7: every field equal
# ---------------------------------------------------------------------------

def test_presets_and_workloads_equal_the_reference():
    for name in ("GPT3", "GOPHER", "LLAMA3", "PALM", "MEGATRON"):
        assert dataclasses.asdict(getattr(sim, name)) == \
            dataclasses.asdict(getattr(ref_sim, name)), name
    assert len(sim.FIG6_WORKLOADS) == len(ref_sim.FIG6_WORKLOADS)
    for a, b in zip(sim.FIG6_WORKLOADS, ref_sim.FIG6_WORKLOADS):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(sim.Calibration()) == \
        dataclasses.asdict(ref_sim.Calibration())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("calib", _calibs(), ids=lambda c: c[0])
def test_simulate_step_equals_reference(kind, calib):
    _, ref_c, port_c = calib
    for w in ref_sim.FIG6_WORKLOADS:
        model = _pair(w.model, sim.LLMConfig)
        par = _pair(w.par, sim.ParallelismConfig)
        want = ref_sim.simulate_step(
            w.model, w.par, ref_sim.make_system(kind, w.par.n_gpus, ref_c))
        got = sim.simulate_step(
            model, par, sim.make_system(kind, par.n_gpus, port_c))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            w.model.name
        assert (got.comm, got.other) == (want.comm, want.other)


def test_colocation_job_step_equals_reference():
    """fig11's training job: colo-13b, dp=8 on 5-accel clusters."""
    args = ("colo-13b", 40, 5120, 40, 4 * 5120, 50257, 2048, 13e9)
    out = []
    for pkg in (ref_sim, sim):
        calib = dataclasses.replace(pkg.Calibration(), cluster_size=5)
        out.append(dataclasses.asdict(pkg.simulate_step(
            pkg.LLMConfig(*args),
            pkg.ParallelismConfig(tp=1, pp=1, dp=8, global_batch_seqs=8),
            pkg.make_system("scalepool", 10, calib))))
    assert out[0] == out[1]
    assert out[1]["comm_dp_exposed"] > 0 and out[1]["offload"] > 0


def test_fig6_and_fig7_rows_equal_reference():
    for a, b in zip(sim.run_fig6(), ref_sim.run_fig6()):
        assert a.model == b.model
        assert (a.speedup, a.comm_inter_speedup) == \
            (b.speedup, b.comm_inter_speedup)
        assert dataclasses.asdict(a.baseline) == \
            dataclasses.asdict(b.baseline)
        assert dataclasses.asdict(a.scalepool) == \
            dataclasses.asdict(b.scalepool)
    assert sim.fig6_summary(sim.run_fig6()) == \
        ref_sim.fig6_summary(ref_sim.run_fig6())
    assert sim.run_fig7() == ref_sim.run_fig7()
    assert sim.fig7_summary(sim.run_fig7()) == \
        ref_sim.fig7_summary(ref_sim.run_fig7())


@settings(deadline=None, max_examples=30)
@given(tp=st.sampled_from([1, 2, 8]), pp=st.sampled_from([1, 2, 9, 16]),
       dp=st.integers(1, 64), cluster=st.sampled_from([5, 8, 72]),
       kind=st.sampled_from(KINDS))
def test_simulate_step_grid_equals_reference(tp, pp, dp, cluster, kind):
    out = []
    for pkg in (ref_sim, sim):
        calib = dataclasses.replace(pkg.Calibration(), cluster_size=cluster)
        par = pkg.ParallelismConfig(tp=tp, pp=pp, dp=dp,
                                    global_batch_seqs=4 * dp)
        out.append(dataclasses.asdict(pkg.simulate_step(
            pkg.GOPHER, par, pkg.make_system(kind, par.n_gpus, calib))))
        out.append(pkg.place(par, cluster))
    assert out[0] == out[2]
    assert dataclasses.asdict(out[1]) == dataclasses.asdict(out[3])


# ---------------------------------------------------------------------------
# costmodel: transfer, collectives, routed phases
# ---------------------------------------------------------------------------

FABRICS = ("infiniband_fabric", "cxl_fabric", "xlink_cluster_fabric",
           "tier2_memory_fabric")


@settings(deadline=None, max_examples=40)
@given(nbytes=st.integers(1, 1 << 34), n=st.integers(1, 512),
       fabric=st.sampled_from(FABRICS),
       scale=st.sampled_from([8, 72, 1024]))
def test_collective_prices_equal_reference(nbytes, n, fabric, scale):
    f_ref = getattr(ref_fb, fabric)(scale)
    f = getattr(fb, fabric)(scale)
    assert f.transfer_time(nbytes) == f_ref.transfer_time(nbytes)
    for name in ("ring_allreduce_time", "reduce_scatter_time",
                 "all_gather_time", "tree_allreduce_time", "allreduce_time",
                 "all_to_all_time", "broadcast_time"):
        assert getattr(cm, name)(f, nbytes, n) == \
            getattr(ref_cm, name)(f_ref, nbytes, n), name
    assert cm.p2p_time(f, nbytes) == ref_cm.p2p_time(f_ref, nbytes)
    groups = max(1, n // 4)
    dom = cm.HierarchicalDomains(f, fb.infiniband_fabric(scale), 4, groups)
    dom_ref = ref_cm.HierarchicalDomains(
        f_ref, ref_fb.infiniband_fabric(scale), 4, groups)
    assert cm.hierarchical_allreduce_time(dom, nbytes) == \
        ref_cm.hierarchical_allreduce_time(dom_ref, nbytes)
    assert cm.flat_allreduce_time(dom, nbytes) == \
        ref_cm.flat_allreduce_time(dom_ref, nbytes)
    assert cm.offload_roundtrip_time(64.0, 1e-6, nbytes, 2e-6) == \
        ref_cm.offload_roundtrip_time(64.0, 1e-6, nbytes, 2e-6)


def _route(pkg_topology, pkg_fb, bw, lat):
    topo = pkg_topology("t")
    topo.add_node("a", "pod")
    topo.add_node("sw", "switch")
    topo.add_node("m", "memory")
    topo.connect("a", "sw", pkg_fb.CXL3, capacity=4 * bw, latency=lat)
    topo.connect("sw", "m", pkg_fb.CXL_CAPACITY, capacity=bw, latency=lat)
    return topo, topo.route("a", "m")


@settings(deadline=None, max_examples=40)
@given(base=st.floats(1e-6, 10.0), bw=st.floats(1e3, 1e12),
       lat=st.floats(0.0, 1e-2), t=st.floats(0.0, 100.0),
       contend=st.booleans())
def test_routed_phase_prices_equal_reference(base, bw, lat, t, contend):
    """``phase_volume`` and ``routed_phase_time`` on the same route, on a
    quiet transport and behind an in-flight flow on the trunk."""
    topo, route = _route(Topology, fb, bw, lat)
    rtopo, rroute = _route(RefTopology, ref_fb, bw, lat)
    assert cm.phase_volume(base, route) == ref_cm.phase_volume(base, rroute)
    tx, rtx = Transport(topo), RefTransport(rtopo)
    if contend:
        tx.begin_transfer(route, bw * base, t, label="serve:a")
        rtx.begin_transfer(rroute, bw * base, t, label="serve:a")
    got = cm.routed_phase_time(tx, route, base, t, label="train:j")
    want = ref_cm.routed_phase_time(rtx, rroute, base, t, label="train:j")
    assert got == want
    if not contend:
        assert got == base          # solo: bit-exact, no stretch


# ---------------------------------------------------------------------------
# the reference's test_simulator.py claims, on the port
# ---------------------------------------------------------------------------

def test_fig6_paper_claims():
    s = sim.fig6_summary(sim.run_fig6())
    assert s["avg_speedup"] == pytest.approx(1.22, rel=0.05)
    assert s["max_speedup"] == pytest.approx(1.84, rel=0.05)
    assert s["avg_comm_inter_speedup"] == pytest.approx(3.79, rel=0.20)


def test_fig7_paper_claims():
    s = sim.fig7_summary(sim.run_fig7())
    assert s["speedup_beyond_accel"] == pytest.approx(1.4, rel=0.08)
    assert s["speedup_beyond_cluster"] == pytest.approx(4.5, rel=0.08)
    assert s["speedup_vs_accel_clusters"] == pytest.approx(1.6, rel=0.08)


def test_fig6_speedup_is_from_communication():
    for r in sim.run_fig6():
        assert r.baseline.compute == pytest.approx(r.scalepool.compute)
        assert r.baseline.comm_inter_raw > r.scalepool.comm_inter_raw


@settings(deadline=None, max_examples=40)
@given(nbytes=st.integers(1, 1 << 32), n=st.integers(2, 512))
def test_allreduce_at_most_ring_and_tree(nbytes, n):
    f = fb.infiniband_fabric(1024)
    t = cm.allreduce_time(f, nbytes, n)
    assert t <= cm.ring_allreduce_time(f, nbytes, n) + 1e-12
    assert t <= cm.tree_allreduce_time(f, nbytes, n) + 1e-12
    assert t > 0


@settings(deadline=None, max_examples=30)
@given(nbytes=st.integers(1 << 10, 1 << 30),
       intra=st.sampled_from([2, 4, 8, 16]),
       groups=st.sampled_from([2, 4, 16, 64]))
def test_hierarchical_beats_flat_on_slow_inter(nbytes, intra, groups):
    dom = cm.HierarchicalDomains(
        intra=fb.xlink_cluster_fabric(72),
        inter=fb.infiniband_fabric(groups * intra),
        intra_size=intra, n_groups=groups)
    assert cm.hierarchical_allreduce_time(dom, nbytes) <= \
        cm.flat_allreduce_time(dom, nbytes) * 1.05


def test_memory_tier_ordering():
    calib = sim.Calibration()
    tiered = sim.make_mem_system("tiered", calib)
    base = sim.make_mem_system("baseline", calib)
    hbm, t1, t2 = tiered.tiers
    assert hbm.access_time(4096) < t1.access_time(4096) < t2.access_time(4096)
    assert t2.access_time(4096) < base.tiers[2].access_time(4096)


def test_placement_logic():
    par = sim.ParallelismConfig(tp=8, pp=9, dp=4, global_batch_seqs=64)
    pl = sim.place(par, cluster_size=72)
    assert pl.pp_boundaries_crossing == 0 and pl.dp_intra_size == 1
    par = sim.ParallelismConfig(tp=8, pp=16, dp=4, global_batch_seqs=64)
    assert sim.place(par, cluster_size=72).pp_boundaries_crossing >= 1


def test_step_time_monotone_in_inter_fabric_load():
    """A busier inter-rack fabric never makes a step faster."""
    w = sim.FIG6_WORKLOADS[1]
    prev = 0.0
    for load in (0.0, 0.3, 0.6, 0.9):
        c = dataclasses.replace(sim.Calibration(), ib_load=load)
        t = sim.simulate_step(w.model, w.par,
                              sim.make_system("baseline", w.par.n_gpus,
                                              c)).total
        assert t >= prev
        prev = t
