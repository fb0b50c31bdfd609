"""The prefill tier: bucketed prefill on prefill-pod engines, exporting
KV page-by-page as the prefill progresses.

A ``PrefillWorker`` owns its own modeled clock and FIFO over a wrapped
``repro_torch.serve.Engine`` used in *prefill-only* mode
(``Engine.prefill_export``): the compute path — bucket rounding, the
``prefill_at`` call, the modeled ``prefill_s(bucket)`` cost, the
last-position argmax — is the colocated admission path's own helper
(``Engine._run_prefill``), so the first token and every exported page payload are
bit-identical to what a colocated prefill would have produced.  What
the worker adds is *time*: page ``i`` of the prompt is modeled as
complete (ready to enter the fabric) once the prefill has processed its
tokens, at ``start + cost * min((i+1)*page_size, prompt_len) / bucket``
— linear progress through the fused prefill program — so the router can
stream pages while the tail of the prompt is still prefilling.

The worker speaks the same unit protocol as ``Engine`` (``clock`` /
``idle`` / ``step() -> dt`` / ``advance_clock``), so ``DisaggCluster``
interleaves prefill and decode tiers on one modeled clock with the
exact ``run_multi_trace`` candidate rules.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, List

from repro_torch.obs.trace import CAT_ENGINE, CAT_REQUEST
from repro_torch.serve.api import Request


@dataclasses.dataclass(eq=False)
class PrefillRecord:
    """One request moving through (or out of) the prefill tier."""

    request: Request
    meta: Any = None               # router cookie (cluster request index)
    submit_clock: float = 0.0
    # filled at prefill completion:
    first_tok: int = 0
    pages: List[Any] = dataclasses.field(default_factory=list)
    departures: List[float] = dataclasses.field(default_factory=list)
    prefill_done: float = 0.0


class PrefillWorker:
    """FIFO prefill executor over one prefill-pod engine.

    ``step()`` prefills the queue head (one request per step, mirroring
    the engine's one-admission granularity) and moves the finished
    record — first token, per-page payloads, per-page fabric-entry
    times — to ``outbox`` for the router to stream and hand off."""

    def __init__(self, engine, *, name: str = "prefill"):
        self.engine = engine
        self.name = name
        self.clock = 0.0
        self.steps = 0
        self.busy_s = 0.0
        self.prefilled = 0
        self._queue: deque = deque()
        self.outbox: deque = deque()
        self._seq = 0

    @property
    def tracer(self):
        return self.engine.tracer

    @property
    def _track(self) -> str:
        return f"prefill:{self.name}"

    @property
    def depth(self) -> int:
        """Queue depth — the router's dispatch-pressure signal."""
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return not self._queue

    def advance_clock(self, t: float) -> None:
        self.clock = max(self.clock, t)

    def submit(self, request: Request, meta: Any = None) -> PrefillRecord:
        """Enqueue a request for prefill (deterministic FIFO).  Token
        ids are validated here, exactly as ``Engine.submit`` would —
        the prefill tier is this request's admission edge."""
        cfg = self.engine.cfg
        if request.prompt_len + request.max_new_tokens > cfg.max_seq:
            raise ValueError(
                f"prompt {request.prompt_len} + max_new "
                f"{request.max_new_tokens} exceeds max_seq {cfg.max_seq}")
        vocab = self.engine.model.cfg.vocab
        bad = [t for t in request.prompt_tokens if not 0 <= t < vocab]
        if bad:
            raise ValueError(
                f"prompt token id {bad[0]} outside the model vocab "
                f"[0, {vocab})")
        rec = PrefillRecord(request, meta,
                            submit_clock=max(self.clock,
                                             request.arrival_time))
        rid = meta if isinstance(meta, int) else self._seq
        self._seq += 1
        self._queue.append(rec)
        if self.tracer.enabled:
            self.tracer.instant(self._track, "submit", rec.submit_clock,
                                cat=CAT_REQUEST, rid=rid,
                                prompt_len=request.prompt_len,
                                max_new=request.max_new_tokens)
        return rec

    def step(self) -> float:
        """Prefill the queue head if it has arrived; else idle-advance
        to its arrival (the same jump ``Engine.step`` makes).  Returns
        modeled seconds."""
        dt = 0.0
        if self._queue:
            rec = self._queue[0]
            if rec.request.arrival_time > self.clock:
                self.advance_clock(rec.request.arrival_time)
            else:
                dt = self._prefill(rec)
                self._queue.popleft()
                self.outbox.append(rec)
                self.prefilled += 1
        self.clock += dt
        if dt > 0.0:
            self.busy_s += dt
        self.steps += 1
        return dt

    def _prefill(self, rec: PrefillRecord) -> float:
        eng = self.engine
        prompt = rec.request.prompt_tokens
        plen = len(prompt)
        tok, pages, cost = eng.prefill_export(prompt)
        bucket = eng._bucket_len(plen)
        ps = eng.cfg.page_size
        start = self.clock
        # page i is fabric-ready once its last real token is prefilled:
        # linear progress through the fused bucket program, so early
        # pages stream while the prompt tail is still computing
        rec.departures = [start + cost * (min((i + 1) * ps, plen) / bucket)
                          for i in range(len(pages))]
        rec.prefill_done = start + cost
        rec.first_tok = tok
        rec.pages = pages
        if self.tracer.enabled:
            rid = rec.meta if isinstance(rec.meta, int) else -1
            self.tracer.span(self._track, "prefill", start, cost,
                             cat=CAT_ENGINE, rid=rid, bucket=bucket,
                             prompt_len=plen)
        return cost
