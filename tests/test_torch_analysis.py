"""The port's analysis tools (``repro_torch.analysis``: sanitizer,
tracediff, racecheck) against the reference's.

On the same event streams the two sanitizers must give the same
report: every synthetic stream of ``tests/test_analysis_sanitizer.py``
(clean, and each seeded fault: a regressed clock, a page in two
tenants, a link over line rate, a partially admitted gang, a handoff
used before its pages landed, ...), and real traces of the port,
clean and hand-corrupted.  The two tracediffs must blame the same
first divergent event, and the two racechecks must give the same
verdict on the same scenario, each under its own package's
``tiebreak``.  Last, the mutations of
``tests/test_analysis_racecheck.py`` applied to the port's scheduler
(the FIFO scan and the DRF share sum through the seam) must be caught
by the port's racecheck and blamed on ``pool:sched``; the reference's
seam must leave the port's runs untouched, so only the port's
``tiebreak`` can catch them."""

import dataclasses
import json
import math

import pytest

from repro import analysis as ref_analysis
from repro.analysis import tiebreak as ref_tiebreak
from repro.obs.trace import Event as RefEvent
from repro_torch import analysis
from repro_torch.analysis import tiebreak
from repro_torch.core import simulator as sim
from repro_torch.obs import Tracer, to_chrome_trace, write_chrome_trace
from repro_torch.obs.trace import Event
from repro_torch.pool import PoolJob, Scheduler, build_inventory

GB = 1e9
SCHED = "pool:sched"


# ---------------------------------------------------------------------------
# synthetic streams: plain tuples, built as either package's Event
# ---------------------------------------------------------------------------

def _span(track, name, ts, dur, cat="engine", **args):
    return ("X", cat, track, name, ts, dur, args)


def _instant(track, name, ts, cat="engine", **args):
    return ("i", cat, track, name, ts, 0.0, args)


def _counter(track, name, ts, value, cat="engine"):
    return ("C", cat, track, name, ts, 0.0, {"value": value})


def _solo_kv(free, hot, pool=10.0):
    return [_instant("engine:a", "kv_pool", 0.0, cat="kv", pages=pool),
            _counter("engine:a", "free_pages", 1.0, free, cat="kv"),
            _counter("engine:a", "hot_pages", 1.0, hot, cat="kv")]


def _shared_kv(hot_a, hot_b, free_b, pool=12.0):
    return [_instant("pool:arbiter", "pool_tenants", 0.0, cat="arbiter",
                     pages=pool, tenants=["a", "b"]),
            _counter("engine:a", "free_pages", 1.0, pool - hot_a, cat="kv"),
            _counter("engine:a", "hot_pages", 1.0, hot_a, cat="kv"),
            _counter("engine:b", "free_pages", 2.0, free_b, cat="kv"),
            _counter("engine:b", "hot_pages", 2.0, hot_b, cat="kv")]


def _revoke(pages, cost_s=0.1, ts=3.0):
    kw = {} if pages is None else {"pages": pages}
    return _instant("pool:arbiter", "revoke", ts, cat="arbiter", victim="a",
                    requester="b", rid=0, cost_s=cost_s, **kw)


def _sched_base():
    return [_instant(SCHED, "sched_pool", 0.0, cat="sched", accels=8.0,
                     tier2_gb=100.0)]


def _job(name, submit_t, admit_t, finish_t, jct=None):
    return [_instant(SCHED, "submit", submit_t, cat="sched", job=name),
            _instant(SCHED, "admit", admit_t, cat="sched", job=name, gang=""),
            _span(SCHED, f"run:{name}", admit_t, finish_t - admit_t,
                  cat="sched", job=name),
            _instant(SCHED, "finish", finish_t, cat="sched", job=name,
                     jct_s=finish_t - submit_t if jct is None else jct)]


def _gang(t_a, t_b, gang_at=None, members=2):
    evs = _sched_base() + [
        _instant(SCHED, "submit", 0.0, cat="sched", job="a"),
        _instant(SCHED, "submit", 0.0, cat="sched", job="b"),
        _instant(SCHED, "admit", t_a, cat="sched", job="a", gang="g"),
        _instant(SCHED, "admit", t_b, cat="sched", job="b", gang="g")]
    if gang_at is not None:
        evs.append(_instant(SCHED, "gang_admit", gang_at, cat="sched",
                            gang="g", members=members))
    return evs


def _handoff(use_ts=3.0, pages=(0, 1), span_bytes=200.0, span_end=None):
    ready = (1.0, 2.0)
    evs = [_instant("disagg:req0", "handoff_page", 0.1 * (i + 1), cat="kv",
                    page=p, bytes=100.0, ready_ts=ready[i])
           for i, p in enumerate(pages)]
    end = max(ready) if span_end is None else span_end
    evs.append(_span("disagg:req0", "handoff", 0.1, end - 0.1, cat="kv",
                     pages=2, bytes=span_bytes))
    evs.append(_instant("disagg:req0", "handoff_use", use_ts, cat="kv",
                        pages=2))
    return evs


_BEGIN = _instant("fabric", "begin_transfer", 0.0, cat="fabric", fid=7,
                 bytes=100.0)

# name -> (stream, truncated, expected ok)
STREAMS = {
    "clean-compute": ([_span("engine:a", "prefill", 0.0, 1.0),
                       _span("engine:a", "decode", 1.0, 0.5)], False, True),
    "nan-clock": ([_span("engine:a", "decode", math.nan, 0.1)], False,
                  False),
    "inf-clock": ([_span("engine:a", "decode", math.inf, 0.1)], False,
                  False),
    "negative-dur": ([_span("engine:a", "decode", 1.0, -0.5)], False, False),
    "regressed-clock": ([_span("engine:a", "prefill", 0.0, 1.0),
                         _span("engine:a", "kv_fetch", 0.2, 0.1, cat="kv")],
                        False, False),
    "monotone-exemptions": ([_span("engine:a", "prefill", 0.0, 1.0),
                             _instant("engine:a", "submit", 0.1),
                             _instant("engine:a", "recompute_drop", 0.2,
                                      cat="kv"),
                             _instant("pool:arbiter", "revoke", 5.0),
                             _instant("pool:arbiter", "charge", 2.0)],
                            False, True),
    "overlapping-compute": ([_span("engine:a", "decode", 0.0, 1.0),
                             _span("engine:a", "decode", 0.5, 1.0)], False,
                            False),
    "kv-overlaps-compute": ([_span("engine:a", "decode", 0.0, 1.0),
                             _span("engine:a", "kv_spill", 0.5, 1.0,
                                   cat="kv", pages=2),
                             _span("engine:a/kv", "kv_spill", 0.5, 1.0,
                                   cat="kv")], False, True),
    "transfer-without-begin": ([_span("fabric", "xfer", 1.0, 0.5,
                                      cat="fabric", fid=7, bytes=100.0)],
                               False, False),
    "begin-after-span": ([_instant("fabric", "begin_transfer", 2.0,
                                   cat="fabric", fid=7, bytes=100.0),
                          _span("fabric", "xfer", 1.0, 0.5, cat="fabric",
                                fid=7, bytes=100.0)], False, False),
    "transfer-byte-mismatch": ([_BEGIN, _span("fabric", "xfer", 0.5, 0.5,
                                             cat="fabric", fid=7,
                                             bytes=300.0)], False, False),
    "transfer-paired": ([_BEGIN, _span("fabric", "xfer", 0.5, 0.5,
                                      cat="fabric", fid=7, bytes=100.0)],
                        False, True),
    "begin-in-flight": ([_BEGIN], False, True),
    "link-faster-than-solo": ([_span("link:x", "xfer", 0.0, 0.5, cat="link",
                                     bytes=10.0, solo_s=1.0, capacity=1e9)],
                              False, False),
    "link-over-line-rate": ([_span("link:x", "xfer", 0.0, 1.0, cat="link",
                                   bytes=200.0, solo_s=0.5,
                                   capacity=100.0)], False, False),
    "link-multiplied": ([_span("link:x", "a", 0.0, 1.0, cat="link",
                               bytes=100.0, solo_s=1.0, capacity=100.0),
                         _span("link:x", "b", 0.0, 1.0, cat="link",
                               bytes=100.0, solo_s=1.0, capacity=100.0)],
                        False, False),
    "link-fair-shared": ([_span("link:x", "a", 0.0, 2.0, cat="link",
                                bytes=100.0, solo_s=1.0, capacity=100.0),
                          _span("link:x", "b", 0.0, 2.0, cat="link",
                                bytes=100.0, solo_s=1.0, capacity=100.0)],
                         False, True),
    "kv-solo-clean": (_solo_kv(4.0, 6.0), False, True),
    "kv-solo-leak": (_solo_kv(4.0, 5.0), False, False),
    "kv-solo-conjure": (_solo_kv(4.0, 7.0), False, False),
    "kv-shared-clean": (_shared_kv(5.0, 3.0, 4.0), False, True),
    "page-in-two-tenants": (_shared_kv(5.0, 3.0, 5.0), False, False),
    "page-freed-twice": (_shared_kv(5.0, 3.0, 4.0) + [_revoke(9)], False,
                         False),
    "revoke-folds": (_shared_kv(5.0, 3.0, 4.0) + [
        _revoke(2), _counter("engine:a", "free_pages", 4.0, 6.0, cat="kv"),
        _counter("engine:a", "hot_pages", 4.0, 3.0, cat="kv")], False, True),
    "kv-pre-instrumented": (_shared_kv(5.0, 3.0, 4.0) + [
        _revoke(None), _counter("engine:a", "free_pages", 4.0, 0.0,
                                cat="kv"),
        _counter("engine:a", "hot_pages", 4.0, 0.0, cat="kv")], False, True),
    "kv-truncated": (_shared_kv(5.0, 3.0, 4.0) + [_revoke(9)], True, True),
    "regressed-clock-truncated": ([_span("engine:a", "prefill", 0.0, 1.0),
                                   _span("engine:a", "decode", 0.2, 0.1)],
                                  True, False),
    "sched-clean": (_sched_base() + [
        _counter(SCHED, "free_accels", 0.5, 6.0, cat="sched"),
        _counter(SCHED, "busy_accels", 0.5, 2.0, cat="sched"),
        _counter(SCHED, "drf_share:u", 0.5, 0.25, cat="sched")]
        + _job("j0", 0.0, 1.0, 5.0), False, True),
    "sched-accel-leak": (_sched_base() + [
        _counter(SCHED, "free_accels", 1.0, 4.0, cat="sched"),
        _counter(SCHED, "busy_accels", 1.0, 2.0, cat="sched")], False,
        False),
    "sched-accel-conjure": (_sched_base() + [
        _counter(SCHED, "free_accels", 1.0, 7.0, cat="sched"),
        _counter(SCHED, "busy_accels", 1.0, 3.0, cat="sched")], False,
        False),
    "sched-no-geometry": ([_counter(SCHED, "free_accels", 1.0, 4.0,
                                    cat="sched"),
                           _counter(SCHED, "busy_accels", 1.0, 2.0,
                                    cat="sched")], False, True),
    "drf-share-over-one": ([_counter(SCHED, "drf_share:u", 1.0, 1.25,
                                     cat="sched")], False, False),
    "drf-share-negative-truncated": ([_counter(SCHED, "drf_share:u", 1.0,
                                               -0.5, cat="sched")], True,
                                     False),
    "finish-before-admit": (_sched_base() + [
        _instant(SCHED, "submit", 0.0, cat="sched", job="j"),
        _instant(SCHED, "admit", 2.0, cat="sched", job="j", gang=""),
        _instant(SCHED, "finish", 1.0, cat="sched", job="j", jct_s=1.0)],
        False, False),
    "ghost-admission": (_sched_base() + [
        _instant(SCHED, "admit", 1.0, cat="sched", job="ghost", gang="")],
        False, False),
    "run-not-admitted": (_sched_base() + [
        _span(SCHED, "run:j", 1.0, 2.0, cat="sched", job="j")], False,
        False),
    "double-admission": (_sched_base() + [
        _instant(SCHED, "submit", 0.0, cat="sched", job="j"),
        _instant(SCHED, "admit", 1.0, cat="sched", job="j", gang=""),
        _instant(SCHED, "admit", 2.0, cat="sched", job="j", gang="")],
        False, False),
    "wrong-jct": (_sched_base() + _job("j", 0.0, 1.0, 5.0, jct=3.0), False,
                  False),
    "preempt-reopens": (_sched_base() + [
        _instant(SCHED, "submit", 0.0, cat="sched", job="j"),
        _instant(SCHED, "admit", 1.0, cat="sched", job="j", gang=""),
        _span(SCHED, "run:j", 1.0, 1.0, cat="sched", job="j"),
        _instant(SCHED, "preempt", 2.0, cat="sched", job="j"),
        _instant(SCHED, "admit", 3.0, cat="sched", job="j", gang=""),
        _span(SCHED, "run:j", 3.0, 1.0, cat="sched", job="j"),
        _instant(SCHED, "finish", 4.0, cat="sched", job="j", jct_s=4.0)],
        False, True),
    "gang-atomic": (_gang(1.0, 1.0, gang_at=1.0), False, True),
    "gang-split-across-rounds": (_gang(1.0, 2.0, gang_at=2.0), False,
                                 False),
    "gang-overcounted": (_gang(1.0, 1.0, gang_at=1.0, members=3), False,
                         False),
    "gang-partially-admitted": (_gang(1.0, 1.0), False, False),
    "gang-truncated": (_gang(1.0, 2.0, gang_at=2.0) + [
        _counter(SCHED, "free_accels", 3.0, 1.0, cat="sched"),
        _counter(SCHED, "busy_accels", 3.0, 1.0, cat="sched")], True, True),
    "charge-priced": (_shared_kv(2.0, 0.0, 10.0) + [
        _revoke(2, cost_s=0.5), _instant("pool:arbiter", "charge", 4.0,
                                         cat="arbiter", tenant="a",
                                         cost_s=0.5)], False, True),
    "charge-over-billed": (_shared_kv(2.0, 0.0, 10.0) + [
        _revoke(2, cost_s=0.5), _instant("pool:arbiter", "charge", 4.0,
                                         cat="arbiter", tenant="a",
                                         cost_s=0.7)], False, False),
    "charge-unrevoked": ([_instant("pool:arbiter", "charge", 2.0,
                                   cat="arbiter", tenant="z", cost_s=0.1)],
                         False, False),
    "handoff-clean": (_handoff(), False, True),
    "handoff-used-before-landed": (_handoff(use_ts=1.5, span_end=1.2),
                                   False, False),
    "handoff-missing-page": ([e for e in _handoff()
                              if not (e[3] == "handoff_page"
                                      and e[6]["page"] == 1)], False, False),
    "handoff-duplicate-page": (_handoff(pages=(0, 0)), False, False),
    "handoff-byte-disagreement": (_handoff(span_bytes=250.0), False, False),
    "handoff-use-without-span": ([_instant("disagg:req0", "handoff_use",
                                           3.0, cat="kv", pages=1)], False,
                                 False),
    "handoff-page-after-use": (_handoff() + [
        _instant("disagg:req0", "handoff_page", 4.0, cat="kv", page=2,
                 bytes=100.0, ready_ts=4.0)], False, False),
    "handoff-unused": ([e for e in _handoff() if e[3] != "handoff_use"],
                       False, True),
}


def _doc(report):
    """A report as JSON text: NaN clocks compare equal as text."""
    return json.dumps(report.to_doc(), sort_keys=True)


def test_rule_sets_equal():
    assert analysis.RULES == ref_analysis.RULES
    assert set(analysis.__all__) == set(ref_analysis.__all__)


@pytest.mark.parametrize("name", list(STREAMS))
def test_sanitizer_verdicts_equal_reference(name):
    stream, truncated, ok = STREAMS[name]
    mine = analysis.sanitize_events([Event(*e) for e in stream],
                                    truncated=truncated)
    theirs = ref_analysis.sanitize_events([RefEvent(*e) for e in stream],
                                          truncated=truncated)
    assert mine.ok is ok, mine.format()
    assert _doc(mine) == _doc(theirs)
    assert mine.format() == theirs.format()


def test_live_hook_agrees_with_offline_and_export(tmp_path):
    """``attach`` on a live port tracer, ``sanitize_tracer``, the Chrome
    export and the file round trip all give one verdict, the
    reference's."""
    tracer = Tracer()
    live = analysis.attach(tracer)
    sched = Scheduler(_inventory(), queueing="drf", tracer=tracer)
    _submit_mix(sched)
    sched.run()
    live.detach()
    tracer.span("t", "after-detach", 99.0, 1.0)
    rep = live.finish()
    assert rep.ok, rep.format()
    assert rep.events == len(tracer) - 1
    offline = analysis.sanitize_events(tracer.events()[:-1])
    assert _doc(offline) == _doc(rep)
    doc = to_chrome_trace(tracer)
    assert _doc(analysis.sanitize_trace_doc(doc)) == \
        _doc(ref_analysis.sanitize_trace_doc(doc))
    path = tmp_path / "sched.json"
    write_chrome_trace(tracer, str(path))
    assert _doc(analysis.sanitize_trace_file(str(path))) == \
        _doc(ref_analysis.sanitize_trace_file(str(path)))
    events, truncated = analysis.events_from_trace_doc(doc)
    ref_events, ref_truncated = ref_analysis.events_from_trace_doc(doc)
    assert [tuple(e) for e in events] == [tuple(e) for e in ref_events]
    assert truncated == ref_truncated


def test_corrupted_port_export_rejected_alike():
    """A real port trace, hand-corrupted: a gang member's admit dropped
    (a partially admitted gang) and a phantom busy accel."""
    tracer = Tracer()
    sched = Scheduler(_inventory(), queueing="drf", tracer=tracer)
    _submit_mix(sched)
    sched.run()
    doc = to_chrome_trace(tracer)
    evs = doc["traceEvents"]
    first_gang_admit = next(i for i, e in enumerate(evs)
                            if e.get("name") == "admit"
                            and e.get("args", {}).get("gang") == "pair")
    del evs[first_gang_admit]
    busy = next(e for e in evs if e.get("name") == "busy_accels")
    busy["args"]["value"] += 1.0
    mine = analysis.sanitize_trace_doc(doc)
    theirs = ref_analysis.sanitize_trace_doc(doc)
    assert not mine.ok
    assert {v.rule for v in mine.violations} >= {"sched-gang-atomic",
                                                  "sched-accel-conservation"}
    assert _doc(mine) == _doc(theirs)


# ---------------------------------------------------------------------------
# tracediff
# ---------------------------------------------------------------------------

PAIRS = {
    "identical": ([_span("engine:a", "decode", 0.0, 1.0, tokens=3),
                   _instant(SCHED, "admit", 2.0, job="x")],
                  [_span("engine:a", "decode", 0.0, 1.0, tokens=3),
                   _instant(SCHED, "admit", 2.0, job="x")]),
    "args": ([_instant(SCHED, "admit", 1.0, job="x"),
              _instant(SCHED, "finish", 2.0, job="x")],
             [_instant(SCHED, "admit", 1.0, job="y"),
              _instant(SCHED, "finish", 2.0, job="x")]),
    "length-and-tracks": ([_instant("t1", "e", 0.0), _instant("t1", "f", 1.0),
                           _instant("only_a", "g", 0.5)],
                          [_instant("t1", "e", 0.0),
                           _instant("only_b", "h", 0.5)]),
    "clock-and-label-drift": ([_span("link:sw->mem", "xfer", 0.0, 1.0,
                                     cat="link", label="serve:a",
                                     bytes=100.0)],
                              [_span("link:sw->mem", "xfer", 0.0, 1.5,
                                     cat="link", label="serve:a",
                                     bytes=160.0)]),
    "two-tracks-first-by-clock": ([_instant("b", "x", 1.0),
                                   _instant("a", "x", 2.0)],
                                  [_instant("b", "y", 1.0),
                                   _instant("a", "y", 2.0)]),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_tracediff_blames_like_reference(name):
    a, b = PAIRS[name]
    mine = analysis.diff_events([Event(*e) for e in a],
                                [Event(*e) for e in b])
    theirs = ref_analysis.diff_events([RefEvent(*e) for e in a],
                                      [RefEvent(*e) for e in b])
    assert mine.identical is (name == "identical")
    assert mine.to_doc() == theirs.to_doc()
    assert mine.format() == theirs.format()
    if not mine.identical:
        assert mine.first().format() == theirs.first().format()


def test_tracediff_files_and_docs_like_reference(tmp_path):
    docs = []
    for n in (1, 2):
        tr = Tracer()
        tr.span("engine:a", "prefill", 0.0, 0.5, tokens=8)
        tr.counter("engine:a", "free_pages", 0.5, float(n))
        docs.append(to_chrome_trace(tr))
        write_chrome_trace(tr, str(tmp_path / f"{n}.json"))
    mine = analysis.diff_trace_docs(*docs)
    assert not mine.identical
    assert mine.to_doc() == ref_analysis.diff_trace_docs(*docs).to_doc()
    files = [str(tmp_path / f"{n}.json") for n in (1, 2)]
    assert analysis.diff_trace_files(*files).to_doc() == \
        ref_analysis.diff_trace_files(*files).to_doc()
    assert analysis.diff_trace_files(files[0], files[0]).identical


# ---------------------------------------------------------------------------
# racecheck: the same verdicts, each package under its own seam
# ---------------------------------------------------------------------------

def _good(tb):
    def scenario(tracer):
        items = {"b": 2.0, "a": 1.0, "c": 3.0}
        for i, (k, v) in enumerate(sorted(tb.order(items.items()))):
            tracer.instant("t", k, float(i), v=v)
        return {"n": len(items)}
    return scenario


def _bad(tb):
    def scenario(tracer):
        order = tb.order({"b": 2.0, "a": 1.0, "c": 3.0}.items())
        for i, (k, v) in enumerate(order):       # no canonical sort!
            tracer.instant("t", k, float(i), v=v)
        return {"first": order[0][0]}
    return scenario


@pytest.mark.parametrize("make", [_good, _bad], ids=["good", "bad"])
def test_racecheck_verdicts_equal_reference(make):
    mine = analysis.racecheck(make(tiebreak), seeds=(1, 2, 3), label="s")
    theirs = ref_analysis.racecheck(make(ref_tiebreak), seeds=(1, 2, 3),
                                    label="s")
    assert mine.ok is (make is _good)
    assert mine.format() == theirs.format()
    assert mine.baseline_events == theirs.baseline_events == 3
    if not mine.ok:
        with pytest.raises(analysis.RaceDivergence, match="DIVERGED"):
            mine.check()


def test_racecheck_rejects_nesting_and_non_mappings():
    with tiebreak.perturb(1):
        assert tiebreak.active()
        with pytest.raises(RuntimeError, match="inside"):
            analysis.racecheck(lambda tr: {}, seeds=(1,))
    assert not tiebreak.active()
    with pytest.raises(TypeError, match="Mapping"):
        analysis.racecheck(lambda tr: [1, 2], seeds=(1,))


def test_tiebreak_streams_equal_reference():
    items = list(range(12))
    for seed in (1, 7, 8):
        with tiebreak.perturb(seed):
            mine = tiebreak.order(items)
        with ref_tiebreak.perturb(seed):
            theirs = ref_tiebreak.order(items)
        assert mine == theirs and sorted(mine) == items
    assert tiebreak.order(items) == items


# ---------------------------------------------------------------------------
# mutations of the port's scheduler: only the port's seam catches them
# ---------------------------------------------------------------------------

def _inventory():
    return build_inventory(n_pods=4, pod_size=8, hbm_per_accel_gb=192.0,
                           n_memory_nodes=2, memory_node_gb=1024.0,
                           interconnect="scalepool")


PAR = sim.ParallelismConfig(tp=2, pp=1, dp=3, global_batch_seqs=66)


def _submit_mix(sched):
    """A gang declared with gang_size whose members arrive a second
    apart, a second user, an elastic job."""
    for i, t in enumerate([0.0, 1.0]):
        sched.submit(PoolJob(f"g{i}", sim.MEGATRON, PAR, n_steps=10,
                             submit_t=t, gang="pair", gang_size=2, user="u"))
    sched.submit(PoolJob("solo", sim.MEGATRON, dataclasses.replace(PAR, dp=2),
                         n_steps=5, submit_t=0.5, user="v"))
    sched.submit(PoolJob("el", sim.MEGATRON, dataclasses.replace(PAR, dp=4),
                         n_steps=6, submit_t=0.5, user="w", elastic=True,
                         min_dp=1))


def _fifo_scenario(tracer):
    """Scarce pool, same-timestamp submissions: FIFO admission order
    decides who runs first."""
    sched = Scheduler(_inventory(), tracer=tracer)
    for i in range(6):
        sched.submit(PoolJob(f"j{i}", sim.MEGATRON, PAR, n_steps=8))
    res = sched.run()
    return {"summary": res.summary(),
            "finish": {n: r.finish_t for n, r in res.records.items()}}


def _seam_calls(monkeypatch, name, make):
    """Patch ``Scheduler.<name>`` with ``make(orig)``, recording whether
    the port's seam was active at each call."""
    calls = []
    orig = getattr(Scheduler, name)
    mutated = make(orig)

    def wrapped(self, *a):
        calls.append(tiebreak.active())
        return mutated(self, *a)
    monkeypatch.setattr(Scheduler, name, wrapped)
    return calls


def test_mutation_unordered_admission_is_caught(monkeypatch):
    assert analysis.racecheck(_fifo_scenario, seeds=(1, 2)).ok
    calls = _seam_calls(monkeypatch, "_gang_groups",
                        lambda orig: lambda self: tiebreak.order(orig(self)))
    rep = analysis.racecheck(_fifo_scenario, seeds=(1, 2, 3),
                             label="mutated")
    assert any(calls), "the port's seam was never active"
    assert not rep.ok
    bad = rep.divergent[0]
    first = bad.trace_diff.first()
    assert first is not None and first.track == SCHED
    assert first.a.name != first.b.name or first.a.args != first.b.args
    assert bad.outcome_diffs

    # the reference's seam does not reach the port: a racecheck driven
    # by it would pass the mutated port vacuously
    calls.clear()
    with ref_tiebreak.perturb(1):
        under_ref = _fifo_scenario(Tracer())
    assert not any(calls)
    assert under_ref == _fifo_scenario(Tracer())


def test_mutation_float_accumulation_order_is_caught(monkeypatch):
    """The DRF dominant share summed in incidental order: float addition
    is not associative, so the ``drf_share`` counter moves by an ulp."""
    def make(orig):
        def mutated(self, user):
            caps = (self.inv.total_accels, self.inv.total_tier2,
                    self.inv.total_tier2_bw)
            use = [0.0, 0.0, 0.0]
            for run in tiebreak.order(list(self._running.values())):
                if run.job.drf_user != user:
                    continue
                use[0] += run.alloc.n_requested
                use[1] += run.job.tier2_bytes
                use[2] += run.job.tier2_bw
            return max(u / c for u, c in zip(use, caps) if c > 0)
        return mutated
    calls = _seam_calls(monkeypatch, "_dominant_share", make)
    terms = (8 * 100 / 3 * GB, 8 * 200 / 7 * GB, 8 * 500 / 11 * GB)

    def scenario(tracer):
        sched = Scheduler(_inventory(), queueing="drf", tracer=tracer)
        for i in range(6):
            sched.submit(PoolJob(f"j{i}", sim.MEGATRON,
                                 dataclasses.replace(PAR, dp=1),
                                 n_steps=4 + i, user=f"u{i % 2}",
                                 tier2_bytes=terms[i // 2]))
        return {"summary": sched.run().summary()}

    rep = analysis.racecheck(scenario, seeds=(1, 2, 3, 4),
                             label="drf-mutated")
    assert any(calls)
    assert not rep.ok, "non-associative accumulation went undetected"
    first = rep.divergent[0].trace_diff.first()
    assert first.track == SCHED and first.a.name.startswith("drf_share:")
