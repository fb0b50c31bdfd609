"""Schedule-perturbation determinism harness ("racecheck").

The repro's bit-exactness claims rest on every tie in the simulators
being broken by a *spec'd total order* — FIFO by submit sequence,
serve-before-train on equal clocks, victim = max over-use then min
name — and never by an incidental enumeration order (dict insertion,
heap pop sequence, list construction).  Incidental orders are
deterministic *today*, which is exactly what makes them dangerous: a
refactor that changes one produces a run that is still reproducible,
just silently different.

This harness makes the distinction testable.  Decision sites in the
scheduler, arbiter, transport, and interleave drivers route their
candidate enumerations through :mod:`repro_torch.analysis.tiebreak`; under
``tiebreak.perturb(seed)`` those enumerations are shuffled before the
spec'd total order is applied.  ``racecheck`` runs one scenario K+1
times — once unperturbed (the baseline) and once per seed — and
asserts the **outcome mapping** (tokens, modeled clocks, metrics
snapshots: whatever the scenario returns) and the **trace event
stream** are bit-identical every time.  On divergence it reports the
differing outcome paths and bisects the traces to the first divergent
event per track (via :mod:`repro_torch.analysis.tracediff`), so the blame
is "track ``pool:sched``, event #41, ``admit`` of job ``b`` instead
of ``a`` at t=12.5" rather than "the numbers changed".

A scenario is a ``Callable[[Tracer], Mapping]``: build *fresh* state
(topology, engines, jobs — never reuse objects across calls), run to
completion against the supplied tracer, return the outcome mapping.
Floats are compared with exact ``==`` — close is not deterministic.

Stdlib-only; scenarios themselves may of course be as heavy as they
like.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.analysis import tiebreak
from repro_torch.analysis.tracediff import TraceDiff, diff_events
from repro_torch.obs.trace import Event, Tracer

__all__ = ["RaceDivergence", "RaceReport", "SeedResult", "racecheck"]

Scenario = Callable[[Tracer], Mapping[str, Any]]

# cap on reported outcome-path diffs per seed; divergence is usually
# one root cause fanned out over many keys, and the trace blame is the
# useful pointer anyway
_MAX_DIFFS = 20


def _is_nan(x: Any) -> bool:
    return isinstance(x, float) and x != x  # repro: allow(no-float-equality) NaN self-inequality IS the NaN test


def _compare(path: str, a: Any, b: Any, out: List[str]) -> None:
    """Recursive bit-exact comparison; appends ``path: a != b`` lines."""
    if len(out) >= _MAX_DIFFS:
        return
    if isinstance(a, Mapping) and isinstance(b, Mapping):
        ka = sorted(a, key=str)
        kb = sorted(b, key=str)
        if ka != kb:
            out.append(f"{path}: key sets differ "
                       f"({sorted(set(map(str, a)) ^ set(map(str, b)))})")
            return
        for k in ka:
            _compare(f"{path}.{k}" if path else str(k), a[k], b[k], out)
        return
    if (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
            and not isinstance(a, str)):
        if len(a) != len(b):
            out.append(f"{path}: length {len(a)} != {len(b)}")
            return
        for i, (xa, xb) in enumerate(zip(a, b)):
            _compare(f"{path}[{i}]", xa, xb, out)
        return
    if _is_nan(a) and _is_nan(b):
        return
    if a != b:
        out.append(f"{path}: {a!r} != {b!r}")


@dataclasses.dataclass(frozen=True)
class SeedResult:
    """One perturbed run vs the baseline."""

    seed: int
    outcome_diffs: Tuple[str, ...]
    trace_diff: TraceDiff

    @property
    def ok(self) -> bool:
        return not self.outcome_diffs and self.trace_diff.identical

    def format(self) -> str:
        if self.ok:
            return f"seed {self.seed}: bit-identical"
        lines = [f"seed {self.seed}: DIVERGED"]
        first = self.trace_diff.first()
        if first is not None:
            lines.append("  first divergent trace event: " + first.format())
        for d in self.outcome_diffs:
            lines.append("  outcome " + d)
        if not self.trace_diff.identical and first is None:
            lines.append("  " + self.trace_diff.format())
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class RaceReport:
    """Verdict of one racecheck: a baseline plus one result per seed."""

    label: str
    seeds: Tuple[int, ...]
    baseline_events: int
    results: Tuple[SeedResult, ...]

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def divergent(self) -> List[SeedResult]:
        return [r for r in self.results if not r.ok]

    def format(self) -> str:
        head = (f"racecheck[{self.label}]: {len(self.seeds)} perturbation "
                f"seeds over {self.baseline_events} baseline events — "
                + ("OK (bit-identical)" if self.ok
                   else f"{len(self.divergent)} DIVERGED"))
        if self.ok:
            return head
        return "\n".join([head] + [r.format() for r in self.divergent])

    def check(self) -> "RaceReport":
        """Raise ``RaceDivergence`` unless every seed was bit-identical."""
        if not self.ok:
            raise RaceDivergence(self)
        return self


class RaceDivergence(AssertionError):
    """A perturbed schedule produced a different run — an incidental
    enumeration order is leaking into outcomes or trace emission."""

    def __init__(self, report: RaceReport):
        self.report = report
        super().__init__(report.format())


def _run(scenario: Scenario) -> Tuple[Mapping[str, Any], List[Event]]:
    tracer = Tracer(capacity=1 << 20)
    outcome = scenario(tracer)
    if not isinstance(outcome, Mapping):
        raise TypeError(
            f"racecheck scenario must return a Mapping outcome, got "
            f"{type(outcome).__name__}")
    if tracer.dropped:
        raise RuntimeError(
            f"racecheck tracer ring dropped {tracer.dropped} events; "
            f"the trace comparison would be blind to early divergence — "
            f"shrink the scenario")
    return outcome, tracer.events()


def racecheck(scenario: Scenario, *, seeds: Sequence[int] = (1, 2, 3, 4),
              label: str = "scenario",
              check: bool = False) -> RaceReport:
    """Run ``scenario`` unperturbed, then once per perturbation seed,
    and compare every run against the baseline bit-for-bit.

    ``seeds`` pick the shuffle streams for ``tiebreak.perturb``; more
    seeds explore more incidental orders at linear cost.  With
    ``check=True`` a divergence raises :class:`RaceDivergence` (whose
    message carries the full blame report) instead of returning.
    """
    if tiebreak.active():
        raise RuntimeError("racecheck cannot run inside tiebreak.perturb()")
    base_outcome, base_events = _run(scenario)
    results: List[SeedResult] = []
    for seed in seeds:
        with tiebreak.perturb(seed):
            outcome, events = _run(scenario)
        diffs: List[str] = []
        _compare("", base_outcome, outcome, diffs)
        results.append(SeedResult(
            seed=int(seed), outcome_diffs=tuple(diffs),
            trace_diff=diff_events(base_events, events)))
    report = RaceReport(label=label, seeds=tuple(int(s) for s in seeds),
                        baseline_events=len(base_events),
                        results=tuple(results))
    if check:
        report.check()
    return report
