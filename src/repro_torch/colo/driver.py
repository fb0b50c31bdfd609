"""Clock-interleaved co-residency driver: training step events and
serving engines on ONE shared modeled clock and ONE shared transport.

``run_colo`` generalizes ``serve.trace.run_multi_trace``: each round
the event source with the earliest next event steps once — a serving
engine decodes/pages, a ``colo.TrainActor`` prices one training step —
so their transfers interleave causally on the shared ``Transport`` and
max-min share its links.

Equivalence contracts (pinned by ``tests/test_torch_colo.py``):

* serving engines occupy candidate indices ``0..n-1`` in pair order —
  exactly ``run_multi_trace``'s ordering — and the per-round selection
  logic is identical, so a run with no training actors is bit-identical
  (tokens AND clocks) to ``run_multi_trace`` on the same pairs;
* a training actor always makes modeled progress (a step is never
  zero seconds), so it participates in the blocked-set protocol only
  by clearing it, never by joining it;
* with no serving pairs the driver just steps each actor to
  completion — bit-identical to calling ``actor.step()`` in a loop,
  which on a quiet fabric is bit-identical to
  ``simulate_step(...).total`` per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis import tiebreak
from repro_torch.colo.collectives import TrainActor
from repro_torch.serve.engine import RequestHandle

Pair = Tuple[object, Sequence]          # (Engine, trace of Requests)


@dataclass
class ColoResult:
    """One co-resident run: serving handle lists (in pair order) plus
    the training actors with their per-step accounting."""
    serve_handles: List[List[RequestHandle]]
    train: List[TrainActor]

    def train_stats(self) -> Dict[str, Dict[str, float]]:
        return {a.name: a.stats() for a in self.train}


def run_colo(pairs: Sequence[Pair], train: Sequence[TrainActor] = (), *,
             max_steps: int = 1_000_000) -> ColoResult:
    """Drive serving engines (per-engine arrival traces) and training
    actors interleaved by modeled clock on their shared transport.

    Candidate order: serving pairs at indices ``0..n-1`` (identical to
    ``run_multi_trace``), training actors appended after — on equal
    clocks serving steps first, deterministically.  A serving engine
    whose step makes no modeled progress (blocked on pages another
    tenant holds) is clock-synced to the next other event and skipped
    until someone progresses; training steps always progress, so a
    co-resident estate deadlocks only if every *serving* engine is
    blocked with no training left to run.
    """
    state = [[eng, sorted(tr, key=lambda r: r.arrival_time), 0, []]
             for eng, tr in pairs]
    n_serve = len(state)
    actors = list(train)
    blocked: set = set()
    for _ in range(max_steps):
        for st in state:
            eng, pend = st[0], st[1]
            while st[2] < len(pend) \
                    and pend[st[2]].arrival_time <= eng.clock:
                st[3].append(eng.submit(pend[st[2]]))
                st[2] += 1
        cands = []
        for j, (eng, pend, i, _) in enumerate(state):
            if not eng.idle:
                cands.append((eng.clock, j))
            elif i < len(pend):
                cands.append((pend[i].arrival_time, j))
        for k, actor in enumerate(actors):
            if not actor.idle:
                cands.append((actor.clock, n_serve + k))
        if not cands:
            return ColoResult([st[3] for st in state], actors)
        live = [c for c in cands if c[1] not in blocked]
        if not live:
            raise RuntimeError(
                "co-residency deadlock: every engine is blocked on pages "
                "another tenant holds and no training remains")
        # total-order selection over (clock, candidate index): equal
        # clocks break serve-before-train by index (spec, not incident)
        # — the racecheck seam permutes the list to prove the selection
        # never depends on construction order
        t, j = min(tiebreak.order(live))
        if j >= n_serve:
            actors[j - n_serve].step()      # always makes progress
            blocked.clear()
            continue
        eng, pend = state[j][0], state[j][1]
        if eng.idle:
            eng.advance_clock(t)
            while state[j][2] < len(pend) \
                    and pend[state[j][2]].arrival_time <= eng.clock:
                state[j][3].append(eng.submit(pend[state[j][2]]))
                state[j][2] += 1
        before = eng.clock
        dt = eng.step()
        if dt > 0.0 or eng.idle or eng.clock != before:  # repro: allow(no-float-equality) identity test — did step() assign a new clock value at all, not a time comparison
            blocked.clear()
        else:
            others = [c[0] for c in cands if c[1] != j]
            if others:
                eng.advance_clock(min(others))
            blocked.add(j)
    raise RuntimeError(f"co-resident workloads not drained after "
                       f"{max_steps} steps")
