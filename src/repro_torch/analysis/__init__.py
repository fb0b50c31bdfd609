"""repro_torch.analysis — static + dynamic correctness tooling for the
estate (the port's copy of ``repro.analysis``).

Four layers, one discipline (modeled-time determinism — the property
every headline claim in this repo rests on):

    lints     — pluggable AST rule engine (``repro_torch.analysis.lints``)
                with per-line ``# repro: allow(<rule>)`` suppressions:
                ``no-bare-print``, ``no-wallclock``, ``compat-imports``,
                ``no-mutable-default``, ``no-unordered-iteration``,
                ``no-float-equality``.  CLI:
                ``python -m repro_torch.analysis.lints src/repro_torch``.
    sanitizer — modeled-time causality checker over ``obs.Tracer``
                event streams, live (``attach(tracer)``) or offline
                from an exported Perfetto JSON
                (``sanitize_trace_file``).
    racecheck — schedule-perturbation determinism harness: the
                ``tiebreak`` seam shuffles incidental candidate
                enumerations in the scheduler/arbiter/transport/
                interleave drivers, and ``racecheck`` proves a
                scenario's outcomes and trace are bit-identical under
                K perturbed schedules.
    tracediff — structural A/B differ over two trace event streams:
                per-track first divergent event, clock drift, and
                by-label byte drift.

Invariants the sanitizer enforces
---------------------------------

* **finite-clock** — every ``ts``/``dur`` finite, ``dur >= 0``.
* **track-monotone** — per-track event *end* times never regress: one
  track is one actor's timeline.  (Exempt: the arbiter's track, which
  stamps events at victims' clocks; future-dated ``submit`` instants;
  ``recompute_drop`` decisions that precede already-emitted spill
  ends.)
* **span-serial** — an engine's compute spans (prefill/decode) never
  overlap: one engine runs one program at a time.
* **transfer-causality** — every fabric transfer span pairs 1:1 with a
  ``begin_transfer`` instant of the same flow id, begin <= completion,
  payload bytes agree.
* **link-conservation** — per link span ``dur >= solo_s`` and
  ``bytes <= capacity * dur``; per link, total bytes fit inside the
  interval-union of its occupancy spans times capacity (concurrent
  flows share a link, they don't multiply it).
* **kv-conservation** — at every engine step-end sample, free pages +
  resident pages across the pool's tenants == pool size: no page
  leaked or double-freed, arbiter revocations included.
* **revocation-attribution** — seconds charged to a victim tenant
  never exceed the revocation costs recorded against it.
* **disagg-handoff** — disaggregated prefill->decode KV streams
  (``disagg:req*`` tracks): every page is transferred before the
  request's first decode step uses it, the page set is complete, and
  per-page payload bytes agree with the handoff span's total.

This module deliberately imports nothing heavyweight (no torch): the
lint CLI and offline sanitizer must start fast enough to run on every
commit.
"""

from repro_torch.analysis import tiebreak
from repro_torch.analysis.racecheck import (RaceDivergence, RaceReport,
                                            SeedResult, racecheck)
from repro_torch.analysis.sanitizer import (RULES, Sanitizer,
                                            SanitizerReport, TraceViolation,
                                            attach, events_from_trace_doc,
                                            sanitize_events, sanitize_tracer,
                                            sanitize_trace_doc,
                                            sanitize_trace_file)
from repro_torch.analysis.tracediff import (EventDelta, TraceDiff,
                                            diff_events, diff_tracers,
                                            diff_trace_docs, diff_trace_files)

__all__ = [
    "EventDelta", "RULES", "RaceDivergence", "RaceReport", "Sanitizer",
    "SanitizerReport", "SeedResult", "TraceDiff", "TraceViolation",
    "attach", "diff_events", "diff_tracers", "diff_trace_docs",
    "diff_trace_files", "events_from_trace_doc", "racecheck",
    "sanitize_events", "sanitize_tracer", "sanitize_trace_doc",
    "sanitize_trace_file", "tiebreak",
]
