"""Contended transfer pricing over a routed ``Topology``.

``Transport`` is the ONE place modeled transfer seconds come from: it
tracks every in-flight transfer on the fabric and prices each by
*interval-based max-min fair sharing* of link bandwidth.  Between
events (a transfer starting or finishing) every flow drains at its
max-min fair rate — on each link, unfrozen flows split the residual
capacity evenly; the most-contended link freezes its flows first
(progressive filling / water-filling, the standard fluid flow model).
When a transfer starts or finishes, everything sharing a link with it
is re-rated.

``begin_transfer(route, nbytes, t) -> completion_time`` registers the
transfer and returns its completion under the *current* in-flight set
(future arrivals will slow flows further; like any online model the
returned time is the best estimate at begin time — by construction it
is exact whenever nothing else arrives, and a lower bound otherwise).

Two guarantees the rest of the repo builds on:

* **solo exactness** — a transfer whose route carries no other flow
  completes in exactly ``route.latency() + nbytes /
  route.bottleneck_bw`` seconds, the same float the legacy
  ``ServeCostModel.swap_s`` computed, so single-tenant degenerate
  runs are bit-identical to the pre-``repro_torch.fabric`` engine;
* **no free lunch** — k concurrent transfers over a shared link each
  finish no earlier than the serial solo transfer (fair sharing never
  exceeds link capacity); the property suite in
  ``tests/test_fabric_transport.py`` pins both.

The transport owns a modeled clock frontier (``now``): transfers
beginning in another consumer's past (engines interleave on their own
clocks) are clamped forward to it, keeping link state causal.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import tiebreak
from repro_torch.fabric.topology import Link, Route, Topology
from repro_torch.obs.export import link_tier
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import CAT_FABRIC, CAT_LINK, Tracer, resolve

# a flow whose residue dips below this is finished: absorbs the float
# dust of ``(now + rem/rate) - now`` round trips (up to ~rate * ulp(now)
# bytes) so back-to-back sequential transfers take the exact solo fast
# path instead of "contending" with a ghost holding micro-bytes.  A
# thousandth of a byte at fabric rates is ~1e-12 modeled seconds.
_EPS_BYTES = 1e-3


@dataclass
class _Flow:
    fid: int
    route: Route
    remaining: float                  # payload bytes left to serialize
    started: float
    nbytes: float = 0.0               # original payload size
    completion: Optional[float] = None   # estimate returned at begin time
    label: Optional[str] = None       # "<class>:<owner>" attribution tag
    rates: List[Tuple[float, float]] = field(default_factory=list)
    # (t, bytes/s) at each re-rating interval — recorded only when a
    # tracer is enabled; exported on the transfer's link-occupancy span


class Transport:
    """Owns the in-flight transfer set (and the modeled clock frontier)
    for one fabric ``Topology``.  Pass a ``repro_torch.obs.Tracer`` to record
    per-transfer link-occupancy spans (with the max-min fair rate at
    every re-rating interval) into the flight recorder; per-link busy
    seconds / bytes / peak-concurrency / queueing-stretch gauges are
    always accumulated (plain float adds on the paths the fluid
    simulation already walks)."""

    def __init__(self, topology: Topology, *,
                 tracer: Optional[Tracer] = None):
        self.topology = topology
        self.tracer = resolve(tracer)
        self.now = 0.0                  # clock frontier (last event time)
        self._flows: Dict[int, _Flow] = {}
        self._fid = itertools.count()
        # observability
        self.transfers = 0
        self.bytes_moved = 0.0
        self.peak_inflight = 0
        self.contended_transfers = 0    # began while sharing >= 1 link
        # per-link accounting (bugfix: stats() used to drop link
        # information entirely, making conservation uncheckable):
        #   busy_s      — modeled seconds the link carried >= 1 flow
        #   bytes       — payload bytes serialized across the link
        #   peak_flows  — max concurrent flows ever crossing it
        #   stretch_s   — contention-induced excess (actual minus solo
        #                 serialization) of flows that crossed it
        self.link_busy_s: Dict[str, float] = {}
        self.link_bytes: Dict[str, float] = {}
        self.link_peak_flows: Dict[str, int] = {}
        self.link_stretch_s: Dict[str, float] = {}
        # per-link payload bytes keyed by flow label ("serve:a",
        # "train:job0", "kv:a", ...) — who occupied the link, not just
        # how much.  Label classes are conventions, not pricing: the
        # "kv:<tenant>" class marks disaggregated prefill->decode page
        # streams (repro_torch.disagg) so link occupancy separates handoff
        # traffic from the same tenant's "serve:" spill traffic.
        # Only labeled flows accrue here; unlabeled traffic keeps the
        # exact legacy accounting and emits byte-identical spans.
        self.link_label_bytes: Dict[str, Dict[str, float]] = {}

    # ---- public API ------------------------------------------------------
    def route(self, src: str, dst: str) -> Route:
        return self.topology.route(src, dst)

    def begin_transfer(self, route: Route, nbytes: float,
                       t: Optional[float] = None, *,
                       label: Optional[str] = None) -> float:
        """Start a transfer of ``nbytes`` payload bytes at modeled time
        ``t`` (>= the frontier; earlier begins are clamped forward).
        Returns the modeled completion time.  In-flight transfers
        sharing any link are re-rated from ``t`` on.  ``label`` tags
        the flow for per-tenant/per-job link attribution (convention:
        ``"<class>:<owner>"``, e.g. ``"serve:a"``, ``"train:job0"``)."""
        return self._begin(route, nbytes, t, label=label)[0]

    def transfer_s(self, route: Route, nbytes: float,
                   t: Optional[float] = None, *,
                   label: Optional[str] = None) -> float:
        """``begin_transfer`` returning the *duration* as seen from the
        requested begin time.  A begin dated before the frontier waits
        for it (causality), and that wait is part of the returned
        duration — so a consumer charging sequential transfers on its
        own (possibly lagging) clock starts each one after the last
        completed instead of stacking them onto one frontier instant
        and contending with itself.  On the solo path the duration is
        the exact ``latency + nbytes/bw`` float (no ``(t + d) - t``
        rounding), so callers accumulating step deltas stay
        bit-identical to the pre-transport cost models."""
        t_req = self.now if t is None else float(t)
        completion, solo, t_eff = self._begin(route, nbytes, t_req,
                                              label=label)
        if solo and nbytes > 0 and t_eff == t_req:  # repro: allow(no-float-equality) identity test of an unclamped begin time, not a tolerance compare — t_eff IS t_req unless max() replaced it
            return route.latency() + nbytes / route.bottleneck_bw
        return completion - t_req

    def _begin(self, route: Route, nbytes: float,
               t: Optional[float], *,
               label: Optional[str] = None) -> Tuple[float, bool, float]:
        """Shared begin path: (completion, was_solo, effective_begin)."""
        t = self.now if t is None else max(float(t), self.now)
        self._advance(t)
        self.transfers += 1
        self.bytes_moved += max(0.0, nbytes)
        if nbytes <= 0:
            return t + route.latency(), True, t
        solo = not any(self._on_link(l) for l in route.links)
        flow = _Flow(next(self._fid), route, float(nbytes), t,
                     nbytes=float(nbytes), label=label)
        self._flows[flow.fid] = flow
        self.peak_inflight = max(self.peak_inflight, len(self._flows))
        for link in route.links:
            n_on = sum(1 for f in self._flows.values()  # repro: allow(no-unordered-iteration) integer count — exact and commutative in any order
                       if link in f.route.links)
            if n_on > self.link_peak_flows.get(link.name, 0):
                self.link_peak_flows[link.name] = n_on
        if solo:
            # exact solo formula — bit-identical to the legacy
            # ServeCostModel.swap_s path (and to Route.transfer_time)
            flow.completion = t + (route.latency()
                                   + nbytes / route.bottleneck_bw)
        else:
            self.contended_transfers += 1
            flow.completion = self._project_completion(flow.fid) \
                + route.latency()
        if self.tracer.enabled:
            rate0 = self._rates({fid: f.remaining for fid, f
                                 in self._flows.items()})[flow.fid]  # repro: allow(no-unordered-iteration) per-key dict build — no cross-key effects
            flow.rates.append((t, rate0))
            self.tracer.instant(
                "fabric", "begin_transfer", t, cat=CAT_FABRIC,
                fid=flow.fid, bytes=flow.nbytes, src=route.src,
                dst=route.dst, solo=solo, rate=rate0,
                est_completion=flow.completion)
        return flow.completion, solo, t

    @property
    def inflight(self) -> int:
        return len(self._flows)

    def link_flows(self, link_name: str) -> int:
        """In-flight transfers currently crossing ``link_name``."""
        link = self.topology.links[link_name]
        return sum(1 for f in self._flows.values() if link in f.route.links)  # repro: allow(no-unordered-iteration) integer count — exact and commutative in any order

    def quiesce(self) -> float:
        """Advance the frontier until every in-flight flow has drained
        (no new arrivals assumed) and return the final ``now``.  Call
        before reading per-link accounting for a whole run: transfers
        only *actually* drain as later begins advance the clock, so the
        last transfers' busy seconds are otherwise still pending."""
        while self._flows:
            remaining = {fid: f.remaining for fid, f in self._flows.items()}  # repro: allow(no-unordered-iteration) per-key dict build — no cross-key effects
            horizon, _, _ = self._drain_interval(remaining, self.now)
            self._advance(horizon)
        return self.now

    def metrics(self, registry: Optional[MetricsRegistry] = None,
                prefix: str = "fabric") -> MetricsRegistry:
        """The transport's observable state under the unified
        ``repro_torch.obs`` schema; ``stats()`` is a thin adapter over this."""
        m = registry if registry is not None else MetricsRegistry()
        m.set(f"{prefix}/now_s", self.now)
        m.set(f"{prefix}/transfers", self.transfers)
        m.set(f"{prefix}/bytes_moved", self.bytes_moved)
        m.set(f"{prefix}/inflight", len(self._flows))
        m.set(f"{prefix}/peak_inflight", self.peak_inflight)
        m.set(f"{prefix}/contended_transfers", self.contended_transfers)
        for name in sorted(self.topology.links):
            lp = f"{prefix}/link/{name}"
            m.set(f"{lp}/busy_s", self.link_busy_s.get(name, 0.0))
            m.set(f"{lp}/bytes", self.link_bytes.get(name, 0.0))
            m.set(f"{lp}/peak_flows", self.link_peak_flows.get(name, 0))
            m.set(f"{lp}/stretch_s", self.link_stretch_s.get(name, 0.0))
        return m

    _STATS_KEYS = ("now_s", "transfers", "bytes_moved", "inflight",
                   "peak_inflight", "contended_transfers")
    _LINK_KEYS = ("busy_s", "bytes", "peak_flows", "stretch_s")

    def stats(self) -> Dict[str, float]:
        """Legacy flat dict — a thin adapter over ``metrics()`` (old
        keys preserved) plus the per-link gauges under ``links``."""
        snap = self.metrics().snapshot()
        out: Dict[str, float] = {k: snap[f"fabric/{k}"]
                                 for k in self._STATS_KEYS}
        out["links"] = {
            name: {k: snap[f"fabric/link/{name}/{k}"]
                   for k in self._LINK_KEYS}
            for name in sorted(self.topology.links)}
        return out

    # ---- fluid simulation ------------------------------------------------
    def _on_link(self, link: Link) -> bool:
        return any(link in f.route.links for f in self._flows.values())  # repro: allow(no-unordered-iteration) boolean any() — commutative in any order

    def _rates(self, remaining: Dict[int, float]) -> Dict[int, float]:
        """Max-min fair rate per flow (progressive filling): repeatedly
        find the most-contended link, freeze its flows at the equal
        split of its residual capacity, remove them, repeat."""
        rates: Dict[int, float] = {}
        live = set(remaining)
        residual = {name: l.capacity for name, l in self.topology.links.items()}  # repro: allow(no-unordered-iteration) per-key dict build — no cross-key effects
        members: Dict[str, List[int]] = {}
        # member-list order is incidental: flows frozen on one
        # bottleneck all receive the SAME share, so the residual
        # subtractions commute bit-exactly (equal values in any
        # association) — the racecheck seam permutes the build
        for fid in tiebreak.order(sorted(live)):
            for l in self._flows[fid].route.links:
                members.setdefault(l.name, []).append(fid)
        while live:
            # bottleneck link: smallest equal share among links with
            # unfrozen flows — a TOTAL-order min over (share, name), so
            # the enumeration order of ``members`` cannot pick the
            # winner
            best: Optional[Tuple[float, str]] = None
            for name, fids in members.items():  # repro: allow(no-unordered-iteration) total-order min over (share, name) — enumeration order irrelevant
                unfrozen = [f for f in fids if f in live]
                if not unfrozen:
                    continue
                share = residual[name] / len(unfrozen)
                if best is None or (share, name) < best:
                    best = (share, name)
            if best is None:        # flows with no shared-capacity links
                for fid in live:
                    rates[fid] = self._flows[fid].route.bottleneck_bw
                break
            share, name = best
            for fid in [f for f in members[name] if f in live]:
                rates[fid] = share
                live.discard(fid)
                for l in self._flows[fid].route.links:
                    residual[l.name] -= share
            residual = {k: max(0.0, v) for k, v in residual.items()}  # repro: allow(no-unordered-iteration) per-key clamp rebuild — no cross-key effects
        return rates

    def _drain_interval(self, remaining: Dict[int, float], now: float,
                        cap: Optional[float] = None
                        ) -> Tuple[float, List[int], Dict[int, float]]:
        """One fluid interval shared by ``_advance`` and
        ``_project_completion``: drain ``remaining`` in place from
        ``now`` to the earlier of ``cap`` and the earliest finish
        event, at current max-min rates.  Returns ``(horizon, finished
        fids, rates)``.  A flow whose computed finish time sets (or
        precedes) the horizon is finished *by that event*, not by its
        float residue — ``(now + rem/rate) - now`` round-trips are not
        exact — with the residue epsilon as a backstop."""
        rates = self._rates(remaining)
        fts = {fid: now + rem / rates[fid]
               for fid, rem in remaining.items()  # repro: allow(no-unordered-iteration) per-key dict build — no cross-key effects
               if rates.get(fid, 0.0) > 0}
        if not fts and cap is None:
            raise RuntimeError("transport: in-flight set cannot drain "
                               "(zero-rate flow)")
        horizon = min(fts.values()) if fts else cap  # repro: allow(no-unordered-iteration) min() of floats — commutative in any order
        if cap is not None:
            horizon = min(horizon, cap)
        dt = horizon - now
        finished: List[int] = []
        # scan order is incidental (per-key updates only) — the seam
        # permutes it; ``finished`` is canonicalized to fid order below
        # because finish order FEEDS order-sensitive effects downstream
        # (trace span emission, float stretch accumulation)
        for fid in tiebreak.order(remaining):
            remaining[fid] -= rates.get(fid, 0.0) * dt
            if fts.get(fid, float("inf")) <= horizon \
                    or remaining[fid] <= _EPS_BYTES:
                finished.append(fid)
        finished.sort()
        return horizon, finished, rates

    def _advance(self, t: float) -> None:
        """Drain every in-flight flow from the frontier to ``t``,
        re-rating at each completion event in between.  This is the
        ONE place flows really progress, so it is also where per-link
        busy/byte accounting accrues and where a finished flow's
        link-occupancy spans hit the flight recorder (its actual
        modeled finish is known here, not at begin time)."""
        while self.now < t and self._flows:
            remaining = {fid: f.remaining for fid, f in self._flows.items()}  # repro: allow(no-unordered-iteration) per-key dict build — no cross-key effects
            horizon, finished, rates = self._drain_interval(
                remaining, self.now, cap=t)
            dt = horizon - self.now
            if dt > 0:
                self._account_interval(dt, rates)
            if self.tracer.enabled:
                for fid, rate in rates.items():  # repro: allow(no-unordered-iteration) per-flow independent appends — no cross-key effects
                    fl = self._flows[fid]
                    if not fl.rates or fl.rates[-1][1] != rate:
                        fl.rates.append((self.now, rate))
            for fid, rem in remaining.items():  # repro: allow(no-unordered-iteration) per-key write-back — no cross-key effects
                self._flows[fid].remaining = rem
            # ``finished`` is in canonical fid order (begin order):
            # trace span emission and stretch accumulation are
            # order-sensitive, so the drain scan's order must not leak
            # into them
            for fid in finished:
                self._finish_flow(self._flows.pop(fid), horizon)
            self.now = horizon
        self.now = max(self.now, t)

    def _account_interval(self, dt: float, rates: Dict[int, float]) -> None:
        """Accrue one fluid interval into the per-link gauges: a link
        is busy for the interval if any flow crosses it, and carries
        each crossing flow's drained bytes (hops pipeline, so a flow's
        payload is serialized across every link of its route)."""
        on_link: Dict[str, float] = {}
        # canonical (fid-sorted) accumulation: per-link byte totals are
        # float adds of UNEQUAL values, which do not commute bit-exactly
        # — the in-flight dict's insertion order must never pick the
        # association.  (Today insertion order IS fid order, so this is
        # an identity change that pins the invariant.)
        for fid in sorted(self._flows):
            flow = self._flows[fid]
            drained = rates.get(fid, 0.0) * dt
            for link in flow.route.links:
                on_link[link.name] = on_link.get(link.name, 0.0) + drained
                if flow.label is not None:
                    by = self.link_label_bytes.setdefault(link.name, {})
                    by[flow.label] = by.get(flow.label, 0.0) + drained
        for name, nbytes in on_link.items():  # repro: allow(no-unordered-iteration) per-key single add into each gauge — no cross-key effects
            self.link_busy_s[name] = self.link_busy_s.get(name, 0.0) + dt
            self.link_bytes[name] = self.link_bytes.get(name, 0.0) + nbytes

    def _finish_flow(self, flow: _Flow, at: float) -> None:
        """A flow fully serialized at modeled time ``at``: attribute
        its queueing stretch to every link it crossed and emit its
        link-occupancy spans."""
        dur = at - flow.started
        solo_s = flow.nbytes / flow.route.bottleneck_bw
        stretch = max(0.0, dur - solo_s)
        for link in flow.route.links:
            self.link_stretch_s[link.name] = \
                self.link_stretch_s.get(link.name, 0.0) + stretch
        if self.tracer.enabled:
            name = f"{flow.route.src}->{flow.route.dst}"
            rates = [(round(t, 9), r) for t, r in flow.rates]
            extra = {} if flow.label is None else {"label": flow.label}
            self.tracer.span(
                "fabric", name, flow.started, dur, cat=CAT_FABRIC,
                fid=flow.fid, bytes=flow.nbytes, solo_s=solo_s,
                stretch_s=stretch, hops=flow.route.hops, rates=rates,
                **extra)
            for link in flow.route.links:
                self.tracer.span(
                    f"link:{link.name}", name, flow.started, dur,
                    cat=CAT_LINK, fid=flow.fid, bytes=flow.nbytes,
                    solo_s=solo_s, capacity=link.capacity,
                    tier=link_tier(link, self.topology), **extra)

    def _project_completion(self, target: int) -> float:
        """Forward-simulate the current in-flight set (no future
        arrivals) until ``target`` drains; pure projection — real state
        is only advanced by ``_advance`` as begin times arrive."""
        remaining = {fid: f.remaining for fid, f in self._flows.items()}  # repro: allow(no-unordered-iteration) per-key dict build — no cross-key effects
        now = self.now
        for _ in range(len(remaining) + 1):
            horizon, finished, _ = self._drain_interval(remaining, now)
            if target in finished:
                return horizon
            for fid in finished:
                del remaining[fid]
            now = horizon
        raise RuntimeError("transport projection failed to converge")
