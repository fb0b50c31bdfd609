"""Structural A/B differ over two ``obs.Tracer`` event streams.

Two runs that claim bit-exactness must produce *identical* event
streams: same tracks, same events per track in the same order, same
modeled clocks, same args.  This module aligns two streams track by
track and reports the **first divergent event per track** — the blame
pointer ``repro_torch.analysis.racecheck`` uses to localize an
order-dependence, and the thing a human wants first when an A/B
regression run stops matching.

Alignment model: events are grouped by ``track`` in emission order
(emission order per track is deterministic in a correct run — that is
the claim under test), then compared positionally.  Cross-track
emission *interleaving* is deliberately NOT compared: two streams with
identical per-track timelines are the same recording even if a
refactor moved an emission site a few lines.  The clock-delta and
by-label byte-delta summaries quantify *how far apart* two non-
identical runs drifted, which turns "the traces differ" into "tenant
b's clock ends 0.41s later and the spine trunk carried 1.2MB more of
``train:job0``".

Entry points mirror the sanitizer's: in-memory events, live tracers,
exported Chrome trace docs, or Perfetto JSON files (the reference's
``JsonlSink`` streaming format is not ported yet).  Stdlib-only;
importing must stay cheap.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import Event

__all__ = [
    "EventDelta", "TraceDiff", "diff_events", "diff_tracers",
    "diff_trace_docs", "diff_trace_files", "load_events",
]

# Event tuple fields compared, in report order
_FIELDS = ("ph", "cat", "name", "ts", "dur", "args")


@dataclasses.dataclass(frozen=True)
class EventDelta:
    """First divergence on one track: positional index, the two events
    (either may be None when one stream's track is a prefix of the
    other's), and which fields differ."""

    track: str
    index: int
    a: Optional[Event]
    b: Optional[Event]
    fields: Tuple[str, ...]

    @property
    def ts(self) -> float:
        """Modeled time of the divergence (earliest side present)."""
        cands = [e.ts for e in (self.a, self.b) if e is not None]
        return min(cands) if cands else 0.0

    def format(self) -> str:
        if self.a is None:
            return (f"track {self.track!r} event #{self.index}: only in "
                    f"B — {_fmt_event(self.b)}")
        if self.b is None:
            return (f"track {self.track!r} event #{self.index}: only in "
                    f"A — {_fmt_event(self.a)}")
        parts = []
        for f in self.fields:
            va, vb = getattr(self.a, f), getattr(self.b, f)
            if f == "args":
                ks = sorted(set(va) | set(vb),
                            key=lambda k: (str(type(k)), str(k)))
                inner = [f"{k}: {va.get(k)!r} != {vb.get(k)!r}"
                         for k in ks if va.get(k) != vb.get(k)]
                parts.append(f"args{{{', '.join(inner)}}}")
            else:
                parts.append(f"{f}: {va!r} != {vb!r}")
        return (f"track {self.track!r} event #{self.index} "
                f"({_fmt_event(self.a)}): {'; '.join(parts)}")


def _fmt_event(ev: Optional[Event]) -> str:
    if ev is None:
        return "<absent>"
    return f"{ev.ph} {ev.name!r} @ {ev.ts:.9f}s"


@dataclasses.dataclass
class TraceDiff:
    """Outcome of one A/B pass.  ``identical`` is the bit-exactness
    verdict; everything else is blame and drift quantification."""

    identical: bool
    events_a: int
    events_b: int
    only_a: List[str]                   # tracks present only in A
    only_b: List[str]
    divergences: List[EventDelta]       # first divergence per track
    clock_delta: Dict[str, float]       # per-track last-event-end B - A
    label_bytes_delta: Dict[str, float]  # per-label link bytes B - A

    def first(self) -> Optional[EventDelta]:
        """The earliest divergence on the modeled clock (ties to track
        name) — racecheck's blame pointer."""
        if not self.divergences:
            return None
        return min(self.divergences, key=lambda d: (d.ts, d.track))

    def format(self) -> str:
        if self.identical:
            return (f"traces identical: {self.events_a} events, "
                    f"bit-exact per track")
        lines = [f"traces DIFFER: {self.events_a} events (A) vs "
                 f"{self.events_b} (B)"]
        for t in self.only_a:
            lines.append(f"  track only in A: {t!r}")
        for t in self.only_b:
            lines.append(f"  track only in B: {t!r}")
        first = self.first()
        for d in sorted(self.divergences, key=lambda d: (d.ts, d.track)):
            tag = "  FIRST " if d is first else "  "
            lines.append(tag + d.format())
        drift = {t: dv for t, dv in sorted(self.clock_delta.items())
                 if dv != 0.0}
        if drift:
            lines.append("  clock drift (B - A): " + ", ".join(
                f"{t}={dv:+.9f}s" for t, dv in drift.items()))
        bdrift = {l: dv for l, dv in
                  sorted(self.label_bytes_delta.items()) if dv != 0.0}
        if bdrift:
            lines.append("  link bytes by label (B - A): " + ", ".join(
                f"{l}={dv:+.0f}B" for l, dv in bdrift.items()))
        return "\n".join(lines)

    def to_doc(self) -> Dict[str, Any]:
        first = self.first()
        return {
            "identical": self.identical,
            "events_a": self.events_a,
            "events_b": self.events_b,
            "only_a": list(self.only_a),
            "only_b": list(self.only_b),
            "first_divergence": None if first is None else {
                "track": first.track, "index": first.index,
                "ts": first.ts, "fields": list(first.fields),
            },
            "divergences": [
                {"track": d.track, "index": d.index, "ts": d.ts,
                 "fields": list(d.fields)}
                for d in self.divergences],
            "clock_delta": dict(self.clock_delta),
            "label_bytes_delta": dict(self.label_bytes_delta),
        }


def _by_track(events: Iterable[Event]) -> Dict[str, List[Event]]:
    out: Dict[str, List[Event]] = {}
    for ev in events:
        out.setdefault(ev.track, []).append(ev)
    return out


def _first_delta(track: str, a: List[Event],
                 b: List[Event]) -> Optional[EventDelta]:
    n = min(len(a), len(b))
    for i in range(n):
        if tuple(a[i]) == tuple(b[i]):
            continue
        fields = tuple(f for f in _FIELDS
                       if getattr(a[i], f) != getattr(b[i], f))
        return EventDelta(track, i, a[i], b[i], fields or ("args",))
    if len(a) != len(b):
        ea = a[n] if n < len(a) else None
        eb = b[n] if n < len(b) else None
        return EventDelta(track, n, ea, eb, ())
    return None


def _label_bytes(events: Sequence[Event]) -> Dict[str, float]:
    """Per-label payload bytes over link-occupancy spans (tracks
    ``link:*``) — the by-label drift summary's raw material."""
    out: Dict[str, float] = {}
    for ev in events:
        if ev.track.startswith("link:") and "label" in ev.args:
            lab = ev.args["label"]
            out[lab] = out.get(lab, 0.0) + float(ev.args.get("bytes", 0.0))
    return out


def diff_events(events_a: Iterable[Event],
                events_b: Iterable[Event]) -> TraceDiff:
    """Structural diff of two event streams (see module docstring for
    the alignment model)."""
    ea, eb = list(events_a), list(events_b)
    ta, tb = _by_track(ea), _by_track(eb)
    only_a = sorted(set(ta) - set(tb))
    only_b = sorted(set(tb) - set(ta))
    divergences: List[EventDelta] = []
    clock_delta: Dict[str, float] = {}
    for track in sorted(set(ta) & set(tb)):
        d = _first_delta(track, ta[track], tb[track])
        if d is not None:
            divergences.append(d)
        end_a = max((e.ts + e.dur for e in ta[track]), default=0.0)
        end_b = max((e.ts + e.dur for e in tb[track]), default=0.0)
        clock_delta[track] = end_b - end_a
    la, lb = _label_bytes(ea), _label_bytes(eb)
    label_delta = {lab: lb.get(lab, 0.0) - la.get(lab, 0.0)
                   for lab in sorted(set(la) | set(lb))}
    identical = not (only_a or only_b or divergences)
    return TraceDiff(
        identical=identical, events_a=len(ea), events_b=len(eb),
        only_a=only_a, only_b=only_b, divergences=divergences,
        clock_delta=clock_delta, label_bytes_delta=label_delta)


def diff_tracers(a, b) -> TraceDiff:
    return diff_events(a.events(), b.events())


def diff_trace_docs(doc_a: Dict[str, Any],
                    doc_b: Dict[str, Any]) -> TraceDiff:
    # deferred import: sanitizer owns the Chrome-doc reconstruction
    from repro_torch.analysis.sanitizer import events_from_trace_doc
    ea, _ = events_from_trace_doc(doc_a)
    eb, _ = events_from_trace_doc(doc_b)
    return diff_events(ea, eb)


def load_events(path: str) -> List[Event]:
    """Events from a trace file: a Perfetto/Chrome JSON export (one
    ``traceEvents`` document)."""
    with open(path) as f:
        doc = json.load(f)
    from repro_torch.analysis.sanitizer import events_from_trace_doc
    events, _ = events_from_trace_doc(doc)
    return events


def diff_trace_files(path_a: str, path_b: str) -> TraceDiff:
    return diff_events(load_events(path_a), load_events(path_b))
