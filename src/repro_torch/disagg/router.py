"""Per-request dispatch between a prefill tier and a decode tier on one
modeled clock.

``DisaggCluster`` glues the two tiers together: a router decides per
arriving request whether it takes the disaggregated path (prefill on a
prefill pod, KV pages streamed over allocator-placed fabric routes,
decode admitted on a decode pod as pages land) or the colocated
fallback (the decode engine prefills locally, exactly the plain
``Engine`` path).  All units — ``PrefillWorker``\\ s and decode
``Engine``\\ s — interleave with the verbatim ``run_multi_trace``
candidate rules, plus one extra candidate kind: the earliest *unrouted*
arrival, which when selected is only dispatched (bound to a unit's
pending queue), never stepped — so routing itself spends no modeled
time and adds no engine steps, and the degenerate single-pod cluster
(``route=None``) replays the plain ``run_trace(Engine)`` schedule
bit-for-bit, tokens and trace events alike.

KV handoff pricing happens here: every exported page enters the shared
``fabric.Transport`` at its prefill-progress departure time under the
``kv:<tenant>`` label, either directly over the pod-to-pod XLink/CXL
route (``staging="direct"``) or staged through a tier-2 memory node —
a write leg then a read leg, two separately-priced transfers
(``staging="tier2"``), which wins when the direct trunk is saturated.
The resulting per-page completion times gate decode-side admission and
first decode; the ``disagg-handoff`` sanitizer rule audits
transferred-before-use from the trace.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.analysis import tiebreak
from repro_torch.disagg.decode import decode_load
from repro_torch.disagg.prefill import PrefillRecord, PrefillWorker
from repro_torch.obs.trace import CAT_KV
from repro_torch.serve.api import Request, RequestHandle

_STAGINGS = ("direct", "tier2")


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Routing and handoff policy knobs.

    staging          -- "direct": pages travel the pod-to-pod route in
                        one priced transfer each; "tier2": each page is
                        written to a staging memory node then read out,
                        two priced legs (``stage_in`` / ``stage_out``).
    min_ready_pages  -- decode-side admission gate: a handed-off
                        request may occupy a slot once this many pages
                        have landed (None: all pages — no partial
                        admission).  First decode always waits for the
                        last page regardless.
    max_transit_s    -- colocated fallback: route a request to the
                        decode tier directly when the solo-predicted
                        KV transit time exceeds this (None: never).
    max_prefill_depth -- colocated fallback: bypass the prefill tier
                        when every prefill queue is at least this deep
                        (None: never).
    """

    staging: str = "direct"
    min_ready_pages: Optional[int] = None
    max_transit_s: Optional[float] = None
    max_prefill_depth: Optional[int] = None

    def __post_init__(self):
        if self.staging not in _STAGINGS:
            raise ValueError(f"staging {self.staging!r} not in {_STAGINGS}")
        if self.min_ready_pages is not None and self.min_ready_pages < 1:
            raise ValueError("min_ready_pages must be >= 1")


class DisaggCluster:
    """One multi-pod lease split into a prefill tier and a decode tier.

    ``run(trace)`` drives a single arrival trace through the router and
    both tiers on one modeled clock and returns one ``RequestHandle``
    per request, in trace order — the same contract as
    ``serve.run_trace``.  With ``route=None`` (prefill and decode share
    a pod) every request takes the colocated path and the cluster is
    bit-identical — tokens *and* trace events — to the plain engine.
    """

    def __init__(self, prefill_workers: Sequence[PrefillWorker],
                 decode_engines: Sequence, *, transport=None,
                 route=None, stage_in=None, stage_out=None,
                 config: Optional[DisaggConfig] = None,
                 tenant: Optional[str] = None, tracer=None):
        if not decode_engines:
            raise ValueError("need at least one decode engine")
        self.prefill_workers = list(prefill_workers)
        self.decode_engines = list(decode_engines)
        self.cfg = config or DisaggConfig()
        self.transport = transport
        self.route = route
        self.stage_in = stage_in
        self.stage_out = stage_out
        self.tenant = tenant or "disagg"
        self.tracer = tracer if tracer is not None \
            else self.decode_engines[0].tracer
        if self.cfg.staging == "tier2":
            if stage_in is None or stage_out is None:
                raise ValueError(
                    "staging='tier2' needs stage_in and stage_out routes "
                    "(allocator handoff legs through the staging memory "
                    "node)")
        # degenerate: no fabric between the tiers — prefill and decode
        # share a pod, so every request takes the colocated path and
        # the prefill workers (if any) sit idle
        self.degenerate = route is None and self.cfg.staging == "direct"
        if not self.degenerate and transport is None:
            raise ValueError("a routed cluster needs the shared transport")
        self.handoffs = 0
        self.colocated = 0
        self._results: List[Optional[RequestHandle]] = []
        self._pend: List[deque] = []

    # ---- routing --------------------------------------------------

    def predict_transit(self, request: Request) -> float:
        """Solo (non-registering) prediction of this request's KV
        transit time — the router's fallback signal.  Uses the decode
        tier's page geometry; all decode engines share one config."""
        if self.degenerate:
            return 0.0
        eng = self.decode_engines[0]
        ps = eng.cfg.page_size
        n_pages = -(-request.prompt_len // ps)
        nbytes = n_pages * eng.kv.page_bytes
        if self.cfg.staging == "tier2":
            return (self.stage_in.transfer_time(nbytes)
                    + self.stage_out.transfer_time(nbytes))
        return self.route.transfer_time(nbytes)

    def _dispatch(self, request: Request, t: float) -> int:
        """Pick the unit index for an arriving request.  Keys are pure
        (load, index) total orders through the tiebreak seam."""
        n_pre = len(self.prefill_workers)
        colocate = self.degenerate or not self.prefill_workers
        if not colocate and self.cfg.max_prefill_depth is not None:
            depths = [w.depth + len(self._pend[j])
                      for j, w in enumerate(self.prefill_workers)]
            if min(depths) >= self.cfg.max_prefill_depth:
                colocate = True
        if not colocate and self.cfg.max_transit_s is not None:
            if self.predict_transit(request) > self.cfg.max_transit_s:
                colocate = True
        if colocate:
            self.colocated += 1
            cands = [(decode_load(e) + len(self._pend[n_pre + k]), k)
                     for k, e in enumerate(self.decode_engines)]
            return n_pre + min(tiebreak.order(cands))[1]
        cands = [(w.depth + len(self._pend[j]), j)
                 for j, w in enumerate(self.prefill_workers)]
        return min(tiebreak.order(cands))[1]

    # ---- handoff --------------------------------------------------

    def _handoff(self, rec: PrefillRecord) -> None:
        """Stream a finished prefill's pages over the fabric and plant
        the request on the least-loaded decode engine."""
        n_pre = len(self.prefill_workers)
        cands = [(decode_load(e) + len(self._pend[n_pre + k]), k)
                 for k, e in enumerate(self.decode_engines)]
        eng = self.decode_engines[min(tiebreak.order(cands))[1]]
        req = rec.request
        pages, deps = rec.pages, rec.departures
        on_use = None
        if req.max_new_tokens <= 1:
            # the first (and only) token was computed by the prefill
            # pod: nothing decodes, so no KV moves and no handoff
            # events are emitted
            ready = [rec.prefill_done] * len(pages)
            transit = 0.0
        else:
            pb = eng.kv.page_bytes
            label = f"kv:{self.tenant}"
            tx = self.transport
            ready = []
            for i, dep in enumerate(deps):
                if self.cfg.staging == "tier2":
                    # write leg into the staging memory node, then a
                    # read leg out of it -- two separately priced
                    # transfers, the read departing when the write lands
                    mid = tx.begin_transfer(self.stage_in, pb, dep,
                                            label=label)
                    ready.append(tx.begin_transfer(self.stage_out, pb, mid,
                                                   label=label))
                else:
                    ready.append(tx.begin_transfer(self.route, pb, dep,
                                                   label=label))
            transit = max(0.0, max(ready) - rec.prefill_done)
            if self.tracer.enabled:
                rid = rec.meta if isinstance(rec.meta, int) else -1
                track = f"disagg:req{rid}"
                # pages first, then the stream span: the span ends at
                # the last page's landing, so this order keeps the
                # per-request track's event ends monotone
                for i, dep in enumerate(deps):
                    self.tracer.instant(track, "handoff_page", dep,
                                        cat=CAT_KV, rid=rid, page=i,
                                        bytes=pb, ready_ts=ready[i])
                self.tracer.span(track, "handoff", deps[0],
                                 max(ready) - deps[0], cat=CAT_KV,
                                 rid=rid, pages=len(pages),
                                 bytes=pb * len(pages),
                                 staging=self.cfg.staging)
                tracer, n, last = self.tracer, len(pages), max(ready)

                def on_use(t: float, *, _tr=tracer, _track=track, _rid=rid,
                           _n=n, _last=last, _transit=transit) -> None:
                    _tr.instant(_track, "handoff_use", t, cat=CAT_KV,
                                rid=_rid, pages=_n, ready_ts=_last)
                    _tr.counter(_track, "kv_transit_s", t, _transit,
                                cat=CAT_KV)

        handle = eng.submit_prefilled(
            req, first_tok=rec.first_tok, prefill_done=rec.prefill_done,
            pages=pages, page_ready=ready,
            min_ready_pages=self.cfg.min_ready_pages,
            kv_transit_s=transit, submit_clock=rec.submit_clock,
            on_first_decode=on_use)
        self.handoffs += 1
        self._results[rec.meta] = handle

    def _drain_outboxes(self) -> None:
        for w in self.prefill_workers:
            while w.outbox:
                self._handoff(w.outbox.popleft())

    # ---- the clock ------------------------------------------------

    def run(self, trace: Sequence[Request], *,
            max_steps: int = 1_000_000) -> List[RequestHandle]:
        """Drive an arrival trace to completion; one handle per request
        in trace order."""
        order = sorted(range(len(trace)),
                       key=lambda i: (trace[i].arrival_time, i))
        units: List[Any] = list(self.prefill_workers) \
            + list(self.decode_engines)
        n_pre = len(self.prefill_workers)
        self._results = [None] * len(trace)
        self._pend = [deque() for _ in units]
        pend = self._pend
        nxt = 0                       # next unrouted request (order index)
        blocked: set = set()

        def feed(j: int) -> None:
            u = units[j]
            while pend[j] and trace[pend[j][0]].arrival_time <= u.clock:
                i = pend[j].popleft()
                if j < n_pre:
                    u.submit(trace[i], meta=i)
                else:
                    self._results[i] = u.submit(trace[i])

        for _ in range(max_steps):
            for j in range(len(units)):
                feed(j)
            cands: List[Tuple[float, int]] = []
            for j, u in enumerate(units):
                if not u.idle:
                    cands.append((u.clock, j))
                elif pend[j]:
                    cands.append((trace[pend[j][0]].arrival_time, j))
            if nxt < len(order):
                cands.append((trace[order[nxt]].arrival_time, -1))
            if not cands:
                missing = [i for i, h in enumerate(self._results)
                           if h is None]
                if missing:
                    raise RuntimeError(
                        f"cluster drained with unfinished requests "
                        f"{missing}")
                return list(self._results)
            live = [c for c in cands if c[1] not in blocked]
            if not live:
                raise RuntimeError(
                    "disagg deadlock: every unit is blocked and no "
                    "arrival can unblock them")
            # same selection rule as run_multi_trace: total-order min
            # over (event time, unit index); the routing pseudo-unit is
            # index -1 so at equal times a request is routed before any
            # real unit steps, and the racecheck seam permutes the list
            t, j = min(tiebreak.order(live))
            if j == -1:
                i = order[nxt]
                nxt += 1
                # routing binds the request to a unit's pending queue;
                # nothing steps and no modeled time passes
                pend[self._dispatch(trace[i], t)].append(i)
                blocked.clear()
                continue
            u = units[j]
            if u.idle:
                u.advance_clock(t)
                feed(j)
            before = u.clock
            dt = u.step()
            self._drain_outboxes()
            if dt > 0.0 or u.idle or u.clock != before:  # repro: allow(no-float-equality) identity test — did step() assign a new clock value at all, not a time comparison
                blocked.clear()
            else:
                others = [c[0] for c in cands if c[1] != j]
                if others:
                    u.advance_clock(min(others))
                blocked.add(j)
        raise RuntimeError(f"disagg trace not drained after "
                           f"{max_steps} steps")
