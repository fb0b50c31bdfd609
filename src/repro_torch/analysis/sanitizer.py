"""Modeled-time causality sanitizer over ``repro_torch.obs`` event streams.

The dynamic half of ``repro_torch.analysis`` (the static half is
``repro_torch.analysis.lints``): every claim the estate makes — solo-exact
transport pricing, conservation of link busy-seconds, fair-share
revocation charged to the victim — is ultimately a statement about the
event stream the flight recorder captures.  This module replays that
stream (live, through a ``Tracer`` hook, or offline from an exported
Perfetto JSON) and checks the causality and conservation invariants a
correct discrete-event simulation cannot violate.  It is the analog of
a race detector for a modeled clock: the instrumented run self-checks,
and CI rejects a PR whose traces stop conserving pages or bytes.

Rules (one violation names rule, track, and modeled timestamp):

``finite-clock``
    Every event's ``ts``/``dur`` is finite and ``dur >= 0`` — NaN/inf
    clocks mean a cost model divided by zero somewhere.
``track-monotone``
    Per track, event *end* times (``ts + dur``) never regress in
    emission order: each track is one actor's timeline, and an actor
    cannot complete an event before the one it already completed.
    Exempt: the ``pool:arbiter`` track (the arbiter stamps events at
    *victims'* clocks, which interleave), ``submit`` instants (future-
    dated to the request's arrival), and ``recompute_drop`` instants
    (stamped at the drop decision, which can precede the end of spill
    spans the same reclaim episode already emitted).
``span-serial``
    Compute spans (``cat="engine"``: prefill/decode) on an engine's
    main track never overlap — one engine executes one program at a
    time.  KV spill/fetch spans are excluded: revocation legitimately
    overlaps a victim's transfers.
``transfer-causality``
    Every fabric transfer span pairs with a ``begin_transfer`` instant
    carrying the same flow id; begin precedes the span's start and the
    payload bytes agree.  Begins without a span are in-flight tails
    (a note, not a violation — the exporter may run pre-``quiesce``).
``link-conservation``
    Per link-occupancy span: ``dur >= solo_s`` (contention only slows)
    and ``bytes <= capacity * dur`` (a link cannot carry more than
    line rate).  Per link at end of stream: the interval *union* of
    its spans times capacity covers the total bytes — concurrent
    flows fair-share one link, they do not multiply it.
``kv-conservation``
    Page accounting: at every engine step-end sample, free pages plus
    resident (hot) pages across the pool's tenants equals the pool
    size — no page is leaked or double-freed, across arbiter
    revocations included.  Cross-tenant mutations between a victim's
    samples (``revoke`` pages, arbiter-initiated ``recompute_drop``
    pages) are folded into the victim's last sample; an estimate
    driven below zero is a double-free.
``revocation-attribution``
    Swap seconds ``charge``d to a tenant never exceed the revocation
    costs recorded against it as victim — nobody is billed for
    traffic that was not priced.
``sched-gang-atomic``
    Pool-scheduler gang admission is all-or-nothing: every
    gang-tagged ``admit`` instant on ``pool:sched`` is covered by a
    same-timestamp ``gang_admit`` naming exactly that many members —
    an uncovered member is a split gang, the failure mode atomic
    admission exists to prevent.
``sched-accel-conservation``
    At every admission-round sample, ``free_accels`` plus
    ``busy_accels`` equals the pool total announced by ``sched_pool``:
    no accelerator leaked by a preemption rollback or double-granted
    by an elastic grow.
``sched-job-span``
    Per job, lifecycle events are causally ordered: ``submit`` <=
    ``hold`` <= ``admit`` <= ``run:*`` segment starts, ``finish`` >=
    the last admit; a job never admits twice without an intervening
    preempt/finish; ``finish``'s ``jct_s`` equals finish minus submit.
``sched-drf-share``
    Every ``drf_share:*`` sample lies in [0, 1] — a dominant share
    above 1 means DRF admitted past a resource's capacity.
``disagg-handoff``
    Disaggregated prefill->decode KV handoff (``disagg:req*`` tracks):
    every page the decode side uses was transferred before use — the
    ``handoff_use`` instant (fired at the request's first decode step)
    lands at or after every page's fabric completion time; the page
    set is complete (as many unique ``handoff_page`` instants as the
    ``handoff`` span announced) with byte agreement between the span
    total and the per-page payloads.  A handoff begun but never used
    is a note, not a violation (the request may have been dropped).

Offline mode reuses the ``link_report_from_trace`` reconstruction
idiom: thread-name metadata maps (pid, tid) back to tracks, µs back to
modeled seconds.  A truncated recording (``recorder_dropped > 0``)
skips the stateful pairing/accounting rules (their baselines may have
been dropped) and says so in the report's notes.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.trace import (CAT_ENGINE, PH_COUNTER, PH_INSTANT, PH_SPAN,
                             Event, Tracer)

__all__ = [
    "RULES", "Sanitizer", "SanitizerReport", "TraceViolation", "attach",
    "events_from_trace_doc", "sanitize_events", "sanitize_tracer",
    "sanitize_trace_doc", "sanitize_trace_file",
]

RULES = ("finite-clock", "track-monotone", "span-serial",
         "transfer-causality", "link-conservation", "kv-conservation",
         "revocation-attribution", "sched-gang-atomic",
         "sched-accel-conservation", "sched-job-span", "sched-drf-share",
         "disagg-handoff")

_ARBITER_TRACK = "pool:arbiter"
_SCHED_TRACK = "pool:sched"
# float tolerance on modeled seconds: within-step costs accumulate in
# different association orders on different paths ((a+b)+c vs a+(b+c)),
# and the µs export round-trips through two more multiplies
_REL = 1e-9


def _tol(t: float) -> float:
    return 1e-9 + _REL * abs(t)


@dataclasses.dataclass(frozen=True)
class TraceViolation:
    rule: str
    track: str
    ts: float
    message: str

    def format(self) -> str:
        return (f"{self.rule}: track={self.track!r} "
                f"t={self.ts:.9f}s: {self.message}")


@dataclasses.dataclass
class SanitizerReport:
    """Outcome of one sanitizer pass: ``ok`` iff no rule fired;
    ``checks`` counts individual assertions per rule (a rule that
    checked nothing passed vacuously — the notes say why)."""

    violations: List[TraceViolation]
    events: int
    tracks: List[str]
    checks: Dict[str, int]
    notes: List[str]

    @property
    def ok(self) -> bool:
        return not self.violations

    def format(self) -> str:
        lines = [f"modeled-time sanitizer: "
                 f"{'PASS' if self.ok else 'FAIL'} — "
                 f"{self.events} events, {len(self.tracks)} tracks, "
                 f"{len(self.violations)} violation(s)"]
        lines.append("checks: " + ", ".join(
            f"{r}={n}" for r, n in self.checks.items()))
        for n in self.notes:
            lines.append(f"note: {n}")
        for v in self.violations:
            lines.append("  " + v.format())
        return "\n".join(lines)

    def to_doc(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "events": self.events,
            "tracks": list(self.tracks),
            "checks": dict(self.checks),
            "notes": list(self.notes),
            "violations": [dataclasses.asdict(v) for v in self.violations],
        }


class Sanitizer:
    """Streaming checker: ``feed`` it events in emission order (or let
    ``attach`` hook it onto a live ``Tracer``), then ``finish()`` for
    the report.  ``truncated=True`` (a ring that dropped events)
    disables the rules whose baselines may be gone."""

    def __init__(self, *, truncated: bool = False):
        self.truncated = truncated
        self.violations: List[TraceViolation] = []
        self.notes: List[str] = []
        self.checks: Dict[str, int] = {r: 0 for r in RULES}
        self._events = 0
        self._tracks: Dict[str, None] = {}
        self._last_end: Dict[str, float] = {}
        self._engine_span_end: Dict[str, float] = {}
        # transfer pairing: fid -> (begin ts, bytes)
        self._begun: Dict[Any, Tuple[float, float]] = {}
        self._paired = 0
        # per link track: coalesced-interval accumulator + byte totals
        self._link_iv: Dict[str, List[Tuple[float, float]]] = {}
        self._link_bytes: Dict[str, float] = {}
        self._link_cap: Dict[str, float] = {}
        # KV page accounting
        self._kv_enabled = not truncated
        self._pool_pages: Dict[str, float] = {}   # per-engine pool size
        self._pool_total: Optional[float] = None  # shared-arbiter pool
        self._pool_tracks: Dict[str, None] = {}   # tracks in shared pool
        self._hot: Dict[str, float] = {}
        self._free: Dict[str, float] = {}
        # revocation attribution (per tenant, cumulative seconds)
        self._revoked_s: Dict[str, float] = {}
        self._charged_s: Dict[str, float] = {}
        # disagg KV handoff state, per "disagg:req*" track:
        # [begin (ts, pages, bytes) | None, {page idx: ready_ts},
        #  page bytes total, used?]
        self._handoff: Dict[str, List[Any]] = {}
        # pool-scheduler lifecycle state (track "pool:sched")
        self._sched_total: Optional[float] = None   # sched_pool accels
        self._sched_free: Optional[float] = None    # last free_accels
        # gang -> [(admit ts, job)] awaiting a covering gang_admit
        self._gang_admits: Dict[str, List[Tuple[float, str]]] = {}
        self._job_submit: Dict[str, float] = {}
        self._job_admit: Dict[str, float] = {}      # last admit ts
        self._job_live: Dict[str, bool] = {}        # currently admitted
        self._tracer: Optional[Tracer] = None
        if truncated:
            self.notes.append(
                "recording truncated (ring dropped events): transfer "
                "pairing, KV accounting, and attribution checks skipped")

    # ---- plumbing --------------------------------------------------------
    def _fail(self, rule: str, track: str, ts: float, msg: str) -> None:
        self.violations.append(TraceViolation(rule, track, ts, msg))

    def detach(self) -> None:
        if self._tracer is not None:
            self._tracer.remove_hook(self.feed)
            self._tracer = None

    # ---- per-event checks ------------------------------------------------
    def feed(self, ev: Event) -> None:
        self._events += 1
        self._tracks.setdefault(ev.track)
        self.checks["finite-clock"] += 1
        if not (math.isfinite(ev.ts) and math.isfinite(ev.dur)) \
                or ev.dur < 0.0:
            self._fail("finite-clock", ev.track, ev.ts,
                       f"{ev.name!r}: ts={ev.ts!r} dur={ev.dur!r} "
                       f"(must be finite, dur >= 0)")
            return          # arithmetic below would just cascade
        self._check_monotone(ev)
        if ev.ph == PH_SPAN:
            self._check_spans(ev)
        if not self.truncated:
            self._feed_kv(ev)
            self._feed_attribution(ev)
            self._feed_disagg(ev)
        self._feed_sched(ev)

    def _check_monotone(self, ev: Event) -> None:
        if ev.track == _ARBITER_TRACK \
                or ev.name in ("submit", "recompute_drop"):
            return
        end = ev.ts + ev.dur
        last = self._last_end.get(ev.track)
        self.checks["track-monotone"] += 1
        if last is not None and end < last - _tol(last):
            self._fail("track-monotone", ev.track, ev.ts,
                       f"{ev.name!r} ends at {end:.9f}s, before the "
                       f"track's previous event end {last:.9f}s — the "
                       f"actor's clock ran backwards")
        self._last_end[ev.track] = max(last or end, end)

    def _check_spans(self, ev: Event) -> None:
        track = ev.track
        if ev.cat == CAT_ENGINE and track.startswith("engine") \
                and "/" not in track:
            prev = self._engine_span_end.get(track)
            self.checks["span-serial"] += 1
            if prev is not None and ev.ts < prev - _tol(prev):
                self._fail("span-serial", track, ev.ts,
                           f"compute span {ev.name!r} starts at "
                           f"{ev.ts:.9f}s, inside the previous compute "
                           f"span (ends {prev:.9f}s) — one engine, two "
                           f"concurrent programs")
            self._engine_span_end[track] = max(prev or 0.0,
                                               ev.ts + ev.dur)
        elif track == "fabric" and "fid" in ev.args:
            self._check_transfer(ev)
        elif track.startswith("link:"):
            self._check_link_span(ev)

    def _check_transfer(self, ev: Event) -> None:
        if self.truncated:
            return
        fid = ev.args["fid"]
        self.checks["transfer-causality"] += 1
        begun = self._begun.pop(fid, None)
        if begun is None:
            self._fail("transfer-causality", ev.track, ev.ts,
                       f"transfer span {ev.name!r} (fid={fid}) has no "
                       f"begin_transfer instant — a completion with no "
                       f"cause")
            return
        b_ts, b_bytes = begun
        self._paired += 1
        if b_ts > ev.ts + _tol(b_ts):
            self._fail("transfer-causality", ev.track, ev.ts,
                       f"fid={fid}: begin at {b_ts:.9f}s is after the "
                       f"transfer span's start {ev.ts:.9f}s")
        if abs(ev.args.get("bytes", b_bytes) - b_bytes) > 0.5:
            self._fail("transfer-causality", ev.track, ev.ts,
                       f"fid={fid}: begin announced {b_bytes} bytes, "
                       f"span carried {ev.args.get('bytes')}")

    def _check_link_span(self, ev: Event) -> None:
        cap = float(ev.args.get("capacity", 0.0))
        nbytes = float(ev.args.get("bytes", 0.0))
        solo = float(ev.args.get("solo_s", 0.0))
        self.checks["link-conservation"] += 1
        if ev.dur + _tol(ev.dur) < solo:
            self._fail("link-conservation", ev.track, ev.ts,
                       f"{ev.name!r}: dur {ev.dur:.9f}s < solo_s "
                       f"{solo:.9f}s — contention made a transfer "
                       f"FASTER than its uncontended time")
        if cap > 0.0 and nbytes > cap * ev.dur * (1.0 + 1e-6) + 0.5:
            self._fail("link-conservation", ev.track, ev.ts,
                       f"{ev.name!r}: {nbytes:.0f} bytes in "
                       f"{ev.dur:.9f}s exceeds line rate "
                       f"{cap:.3e} B/s x dur")
        if cap > 0.0:
            self._link_cap.setdefault(ev.track, cap)
        self._link_bytes[ev.track] = (self._link_bytes.get(ev.track, 0.0)
                                      + nbytes)
        self._merge_interval(ev.track, ev.ts, ev.ts + ev.dur)

    def _merge_interval(self, track: str, s: float, e: float) -> None:
        """Keep the union of span intervals per link as a coalesced
        sorted list (spans arrive roughly by completion, so merges are
        near the tail)."""
        iv = self._link_iv.setdefault(track, [])
        lo, hi = s, e
        keep: List[Tuple[float, float]] = []
        for a, b in iv:
            if b < lo or a > hi:
                keep.append((a, b))
            else:
                lo, hi = min(lo, a), max(hi, b)
        keep.append((lo, hi))
        keep.sort()
        self._link_iv[track] = keep

    # ---- transfer begins / KV / attribution (instants + counters) --------
    def _feed_kv(self, ev: Event) -> None:
        track = ev.track
        if ev.ph == PH_INSTANT:
            if track == "fabric" and ev.name == "begin_transfer":
                fid = ev.args.get("fid")
                if fid in self._begun:
                    self._fail("transfer-causality", track, ev.ts,
                               f"fid={fid}: second begin_transfer "
                               f"while the first is unresolved")
                self._begun[fid] = (ev.ts,
                                    float(ev.args.get("bytes", 0.0)))
            elif ev.name == "kv_pool" and track.startswith("engine"):
                self._pool_pages[track] = float(ev.args.get("pages", 0.0))
            elif ev.name == "pool_tenants" and track == _ARBITER_TRACK:
                self._pool_total = float(ev.args.get("pages", 0.0))
                for t in ev.args.get("tenants", ()):
                    self._pool_tracks.setdefault(f"engine:{t}")
            elif ev.name == "revoke" and track == _ARBITER_TRACK:
                self._adjust_hot(f"engine:{ev.args.get('victim')}",
                                 ev.args.get("pages"), ev)
            elif ev.name == "recompute_drop" and track.startswith("engine"):
                self._adjust_hot(track, ev.args.get("pages"), ev)
        elif ev.ph == PH_COUNTER and track.startswith("engine"):
            if ev.name == "free_pages":
                self._free[track] = float(ev.args.get("value", 0.0))
            elif ev.name == "hot_pages":
                self._hot[track] = float(ev.args.get("value", 0.0))
                self._check_kv_sample(ev)

    def _adjust_hot(self, track: str, pages, ev: Event) -> None:
        """Fold a cross-tenant page mutation into the victim's last
        residency sample.  ONLY revoke/drop events move pages between
        a victim's own step-end samples — its own spills/allocations
        are refreshed by its own next sample before anyone else
        samples (single-threaded drivers interleave whole steps)."""
        if not self._kv_enabled:
            return
        if pages is None:
            self._kv_enabled = False
            self.notes.append(
                f"kv-conservation disabled: {ev.name!r} at "
                f"{ev.ts:.9f}s carries no page count (pre-instrumented "
                f"trace)")
            return
        est = self._hot.get(track, 0.0) - float(pages)
        self._hot[track] = est
        self.checks["kv-conservation"] += 1
        if est < -0.5:
            self._fail("kv-conservation", track, ev.ts,
                       f"{ev.name!r} takes {pages} pages from a tenant "
                       f"holding {est + float(pages):.0f} — pages freed "
                       f"twice")

    def _check_kv_sample(self, ev: Event) -> None:
        if not self._kv_enabled:
            return
        track = ev.track
        free = self._free.get(track)
        if free is None:
            return
        if track in self._pool_tracks and self._pool_total is not None:
            pool = self._pool_total
            hot = sum(self._hot.get(t, 0.0) for t in self._pool_tracks)
            what = (f"shared pool: free {free:.0f} + "
                    f"sum(hot) {hot:.0f}")
        else:
            pool = self._pool_pages.get(track)
            if pool is None:
                return                  # no geometry announced (yet)
            hot = self._hot[track]
            what = f"free {free:.0f} + hot {hot:.0f}"
        self.checks["kv-conservation"] += 1
        if abs(free + hot - pool) > 0.5:
            self._fail("kv-conservation", track, ev.ts,
                       f"{what} != pool {pool:.0f} — "
                       f"{'leaked' if free + hot < pool else 'conjured'}"
                       f" {abs(free + hot - pool):.0f} page(s)")

    # ---- pool-scheduler lifecycle (track "pool:sched") -------------------
    def _feed_sched(self, ev: Event) -> None:
        if ev.track != _SCHED_TRACK:
            return
        if ev.ph == PH_COUNTER and ev.name.startswith("drf_share:"):
            # stateless bound — checked even on truncated recordings
            v = float(ev.args.get("value", 0.0))
            self.checks["sched-drf-share"] += 1
            if not -1e-9 <= v <= 1.0 + 1e-9:
                self._fail("sched-drf-share", ev.track, ev.ts,
                           f"{ev.name!r} = {v!r} outside [0, 1] — DRF "
                           f"admitted past a resource's capacity")
            return
        if self.truncated:
            return          # stateful baselines below may be dropped
        if ev.ph == PH_COUNTER:
            if ev.name == "free_accels":
                self._sched_free = float(ev.args.get("value", 0.0))
            elif ev.name == "busy_accels":
                busy = float(ev.args.get("value", 0.0))
                free = self._sched_free
                if self._sched_total is None or free is None:
                    return      # no geometry announced (pre-instrumented)
                self.checks["sched-accel-conservation"] += 1
                if abs(free + busy - self._sched_total) > 0.5:
                    what = ("leaked" if free + busy < self._sched_total
                            else "conjured")
                    self._fail(
                        "sched-accel-conservation", ev.track, ev.ts,
                        f"free {free:.0f} + busy {busy:.0f} != pool "
                        f"{self._sched_total:.0f} accels — {what} "
                        f"{abs(free + busy - self._sched_total):.0f}")
            return
        if ev.ph == PH_SPAN and ev.name.startswith("run:"):
            job = ev.args.get("job")
            if job is None:
                return
            self.checks["sched-job-span"] += 1
            if not self._job_live.get(job):
                self._fail("sched-job-span", ev.track, ev.ts,
                           f"run segment for job {job!r} at {ev.ts:.9f}s "
                           f"while the job is not admitted")
            admit = self._job_admit.get(job)
            if admit is not None and ev.ts < admit - _tol(admit):
                self._fail("sched-job-span", ev.track, ev.ts,
                           f"run segment for job {job!r} starts at "
                           f"{ev.ts:.9f}s, before its last admit at "
                           f"{admit:.9f}s")
            return
        if ev.ph != PH_INSTANT:
            return
        if ev.name == "sched_pool":
            self._sched_total = float(ev.args.get("accels", 0.0))
        elif ev.name == "submit":
            job = ev.args.get("job")
            if job is not None:
                self._job_submit.setdefault(job, ev.ts)
        elif ev.name == "hold":
            self._check_job_after_submit(ev, "hold")
        elif ev.name == "admit":
            job = self._check_job_after_submit(ev, "admit")
            if job is None:
                return
            self.checks["sched-job-span"] += 1
            if self._job_live.get(job):
                self._fail("sched-job-span", ev.track, ev.ts,
                           f"job {job!r} admitted twice with no "
                           f"intervening preempt/finish")
            self._job_admit[job] = ev.ts
            self._job_live[job] = True
            gang = ev.args.get("gang") or ""
            if gang:
                self._gang_admits.setdefault(gang, []).append((ev.ts, job))
        elif ev.name == "gang_admit":
            self._check_gang_admit(ev)
        elif ev.name == "preempt":
            job = ev.args.get("job")
            if job is not None:
                self._job_live[job] = False
        elif ev.name == "finish":
            job = ev.args.get("job")
            if job is None:
                return
            self.checks["sched-job-span"] += 1
            if not self._job_live.get(job):
                self._fail("sched-job-span", ev.track, ev.ts,
                           f"job {job!r} finished while not admitted")
            self._job_live[job] = False
            admit = self._job_admit.get(job)
            if admit is not None and ev.ts < admit - _tol(admit):
                self._fail("sched-job-span", ev.track, ev.ts,
                           f"job {job!r} finishes at {ev.ts:.9f}s, before "
                           f"its last admit at {admit:.9f}s")
            submit = self._job_submit.get(job)
            jct = ev.args.get("jct_s")
            if submit is not None and jct is not None \
                    and abs(float(jct) - (ev.ts - submit)) > _tol(ev.ts):
                self._fail("sched-job-span", ev.track, ev.ts,
                           f"job {job!r} reports jct_s={float(jct):.9f} "
                           f"but finish - submit = "
                           f"{ev.ts - submit:.9f}s")

    def _check_job_after_submit(self, ev: Event,
                                what: str) -> Optional[str]:
        """Shared submit-precedes check; returns the job name (None if
        the event is unattributable, which is its own violation)."""
        job = ev.args.get("job")
        self.checks["sched-job-span"] += 1
        if job is None:
            self._fail("sched-job-span", ev.track, ev.ts,
                       f"{ev.name!r} instant carries no job name")
            return None
        submit = self._job_submit.get(job)
        if submit is None:
            self._fail("sched-job-span", ev.track, ev.ts,
                       f"job {job!r} {what} at {ev.ts:.9f}s was never "
                       f"submitted")
        elif ev.ts < submit - _tol(submit):
            self._fail("sched-job-span", ev.track, ev.ts,
                       f"job {job!r} {what} at {ev.ts:.9f}s precedes its "
                       f"submit at {submit:.9f}s")
        return job

    def _check_gang_admit(self, ev: Event) -> None:
        gang = ev.args.get("gang")
        want = int(ev.args.get("members", 0))
        buf = self._gang_admits.pop(gang, [])
        got = [j for ts, j in buf if abs(ts - ev.ts) <= _tol(ev.ts)]
        stale = [j for ts, j in buf if abs(ts - ev.ts) > _tol(ev.ts)]
        self.checks["sched-gang-atomic"] += 1
        for j in sorted(stale):
            self._fail("sched-gang-atomic", ev.track, ev.ts,
                       f"gang {gang!r}: member {j!r} admitted at a "
                       f"different timestamp than its gang_admit "
                       f"({ev.ts:.9f}s) — gang split across rounds")
        if len(got) != want:
            self._fail("sched-gang-atomic", ev.track, ev.ts,
                       f"gang {gang!r}: gang_admit names {want} "
                       f"member(s) but {len(got)} gang-tagged admit(s) "
                       f"landed at {ev.ts:.9f}s "
                       f"({sorted(got)})")

    # ---- disaggregated KV handoff (tracks "disagg:req*") -----------------
    def _feed_disagg(self, ev: Event) -> None:
        if not ev.track.startswith("disagg:"):
            return
        st = self._handoff.setdefault(ev.track, [None, {}, 0.0, False])
        if ev.ph == PH_SPAN and ev.name == "handoff":
            self.checks["disagg-handoff"] += 1
            if st[0] is not None:
                self._fail("disagg-handoff", ev.track, ev.ts,
                           f"second handoff span on one request track — "
                           f"a request's KV is streamed exactly once")
                return
            st[0] = (ev.ts, int(ev.args.get("pages", 0)),
                     float(ev.args.get("bytes", 0.0)))
            return
        if ev.ph != PH_INSTANT:
            return
        if ev.name == "handoff_page":
            # pages precede their stream span (the span's end is the
            # last page's landing); completeness is checked at use time
            self.checks["disagg-handoff"] += 1
            if st[3]:
                self._fail("disagg-handoff", ev.track, ev.ts,
                           f"page transferred after the request's first "
                           f"decode already used the stream")
                return
            idx = int(ev.args.get("page", -1))
            if idx in st[1]:
                self._fail("disagg-handoff", ev.track, ev.ts,
                           f"page {idx} transferred twice in one handoff")
                return
            st[1][idx] = float(ev.args.get("ready_ts", ev.ts))
            st[2] += float(ev.args.get("bytes", 0.0))
        elif ev.name == "handoff_use":
            self.checks["disagg-handoff"] += 1
            if st[0] is None:
                self._fail("disagg-handoff", ev.track, ev.ts,
                           f"handoff_use with no handoff span — decode "
                           f"consumed KV nobody streamed")
                return
            begin_ts, want_pages, want_bytes = st[0]
            st[3] = True
            if len(st[1]) != want_pages:
                self._fail("disagg-handoff", ev.track, ev.ts,
                           f"decode started with {len(st[1])} of "
                           f"{want_pages} announced page(s) transferred")
            if abs(st[2] - want_bytes) > 0.5 + _REL * abs(want_bytes):
                self._fail("disagg-handoff", ev.track, ev.ts,
                           f"per-page payloads total {st[2]:.0f}B but "
                           f"the handoff span announced "
                           f"{want_bytes:.0f}B")
            late = {i: r for i, r in st[1].items()
                    if r > ev.ts + _tol(ev.ts)}
            for i in sorted(late):
                self._fail("disagg-handoff", ev.track, ev.ts,
                           f"page {i} decoded before its transfer "
                           f"completed (ready at {late[i]:.9f}s, first "
                           f"decode at {ev.ts:.9f}s)")

    def _feed_attribution(self, ev: Event) -> None:
        if ev.ph != PH_INSTANT or ev.track != _ARBITER_TRACK:
            return
        if ev.name == "revoke":
            v = ev.args.get("victim")
            self._revoked_s[v] = (self._revoked_s.get(v, 0.0)
                                  + float(ev.args.get("cost_s", 0.0)))
        elif ev.name == "charge":
            t = ev.args.get("tenant")
            c = self._charged_s.get(t, 0.0) + float(ev.args.get(
                "cost_s", 0.0))
            self._charged_s[t] = c
            owed = self._revoked_s.get(t, 0.0)
            self.checks["revocation-attribution"] += 1
            if c > owed + _tol(owed):
                self._fail("revocation-attribution", ev.track, ev.ts,
                           f"tenant {t!r} charged {c:.9f}s total but "
                           f"only {owed:.9f}s of revocation cost was "
                           f"recorded against it — billed for traffic "
                           f"nobody priced")

    # ---- end of stream ---------------------------------------------------
    def finish(self) -> SanitizerReport:
        for track, nbytes in sorted(self._link_bytes.items()):
            cap = self._link_cap.get(track, 0.0)
            if cap <= 0.0:
                continue
            busy = sum(e - s for s, e in self._link_iv.get(track, ()))
            self.checks["link-conservation"] += 1
            if nbytes > cap * busy * (1.0 + 1e-6) + 0.5:
                self._fail("link-conservation", track, 0.0,
                           f"{nbytes:.0f} total bytes but only "
                           f"{busy:.9f}s of occupied time at "
                           f"{cap:.3e} B/s — more payload than the "
                           f"link's busy window can carry")
        for gang in sorted(self._gang_admits):
            members = sorted(j for _, j in self._gang_admits[gang])
            self.checks["sched-gang-atomic"] += 1
            self._fail("sched-gang-atomic", _SCHED_TRACK,
                       self._gang_admits[gang][0][0],
                       f"gang {gang!r}: gang-tagged admit(s) {members} "
                       f"never covered by a gang_admit — split gang")
        unused = sorted(t for t, st in self._handoff.items()
                        if st[0] is not None and not st[3])
        if unused:
            self.notes.append(
                f"{len(unused)} KV handoff(s) streamed but never used "
                f"by a decode step ({unused[:5]}"
                f"{'...' if len(unused) > 5 else ''}) — request dropped "
                f"or recording ended early")
        if self._begun:
            fids = sorted(self._begun, key=str)[:5]
            self.notes.append(
                f"{len(self._begun)} transfer(s) still in flight at end "
                f"of stream (fids {fids}{'...' if len(self._begun) > 5 else ''}"
                f") — exporter ran before quiesce()")
        if self._paired:
            self.notes.append(f"{self._paired} transfer span(s) paired "
                              f"with their begin instants")
        return SanitizerReport(
            violations=list(self.violations),
            events=self._events,
            tracks=list(self._tracks),
            checks=dict(self.checks),
            notes=list(self.notes),
        )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def attach(tracer: Tracer) -> Sanitizer:
    """Hook a live sanitizer onto ``tracer``: every subsequently
    emitted event is checked as it happens (before the ring can drop
    it).  Call ``finish()`` for the report and ``detach()`` to stop
    observing."""
    s = Sanitizer()
    tracer.add_hook(s.feed)
    s._tracer = tracer
    return s


def sanitize_events(events: Iterable[Event], *,
                    truncated: bool = False) -> SanitizerReport:
    s = Sanitizer(truncated=truncated)
    for ev in events:
        s.feed(ev)
    return s.finish()


def sanitize_tracer(tracer: Tracer) -> SanitizerReport:
    """Offline pass over a tracer's surviving ring contents."""
    return sanitize_events(tracer.events(), truncated=tracer.dropped > 0)


def events_from_trace_doc(doc: Dict[str, Any]
                          ) -> Tuple[List[Event], int]:
    """Rebuild ``(events, dropped)`` from an exported Chrome trace_event
    document: thread-name metadata maps (pid, tid) back to tracks, µs
    back to modeled seconds.  Event order in the file IS emission
    order (the exporter appends metadata first, then the ring)."""
    names: Dict[int, Dict[int, str]] = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names.setdefault(e["pid"], {})[e["tid"]] = e["args"]["name"]
    out: List[Event] = []
    for e in doc.get("traceEvents", []):
        ph = e.get("ph")
        if ph not in (PH_SPAN, PH_INSTANT, PH_COUNTER):
            continue
        track = names.get(e.get("pid"), {}).get(e.get("tid"))
        if track is None:
            track = f"pid{e.get('pid')}:tid{e.get('tid')}"
        out.append(Event(ph, e.get("cat", ""), track, e.get("name", ""),
                         e.get("ts", 0.0) / 1e6,
                         e.get("dur", 0.0) / 1e6,
                         dict(e.get("args", {}))))
    dropped = int(doc.get("otherData", {}).get("recorder_dropped", 0))
    return out, dropped


def sanitize_trace_doc(doc: Dict[str, Any]) -> SanitizerReport:
    events, dropped = events_from_trace_doc(doc)
    return sanitize_events(events, truncated=dropped > 0)


def sanitize_trace_file(path: str) -> SanitizerReport:
    with open(path) as f:
        return sanitize_trace_doc(json.load(f))
