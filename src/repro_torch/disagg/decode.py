"""The decode tier: receiving streamed KV into the decode-side paged
pool and running the engine's existing decode loop.

There is deliberately almost no machinery here — the receive side *is*
the colocated ``repro_torch.serve.Engine``, entered through its
``submit_prefilled`` seam: a handed-off request carries its first token
(computed on the prefill pod), its page payloads, and the modeled
fabric completion time of every page.  The engine gates admission on
the first ``min_ready_pages`` arrivals (pages are written into
the pool the moment a slot frees), and gates the request's *first
decode step* on the final page's arrival — partial-arrival admission
with transferred-before-use decode, which the ``disagg-handoff``
sanitizer rule checks from the trace.

Because the engine decodes a handed-off row with exactly the same
decode call, page layout, and arbiter state transitions it would use
for a locally-prefilled row, the decoded tokens are the colocated run's
— the fabric only moves *when* decode may start, never *what* it
computes.  (On the card a handed-off row may sit in another row bucket
than it would colocated; the paged kernel's rows do not depend on the
batch, but a GEMM at another row count may round differently in bf16.)

What does live here is tier placement: ``decode_load`` /
``pick_decode_engine`` define the deterministic least-loaded choice the
router uses to spread handoffs across the decode tier.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.analysis import tiebreak


def decode_load(engine) -> int:
    """Outstanding work on a decode engine: occupied slots + queued
    requests + handoffs still waiting for pages/slots.  Pure integers —
    the router's placement key must be a total order."""
    occupied = sum(1 for s in engine._slots if s is not None)
    return occupied + len(engine._queue) + len(engine._handoffs) + len(
        engine._paused)


def pick_decode_engine(engines: Sequence) -> int:
    """Index of the least-loaded decode engine, lowest index winning
    ties.  Routed through ``tiebreak.order`` so ``--racecheck`` can
    perturb the choice and prove outcomes don't depend on it beyond the
    documented (load, index) key."""
    cands: List[Tuple[int, int]] = [(decode_load(e), j)
                                    for j, e in enumerate(engines)]
    return min(tiebreak.order(cands))[1]
