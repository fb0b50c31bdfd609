"""Typed event tracing on the modeled clock — the flight recorder.

Every modeled-time subsystem (``fabric.Transport``, ``serve.Engine``,
``serve.PoolArbiter``, ``pool.Scheduler``) accepts a ``Tracer`` and
emits typed events at the *modeled* timestamps its cost models already
compute: request lifecycle spans (submit → admit → prefill → decode →
finish, with pause/spill/fetch/recompute sub-events), per-transfer
link-occupancy spans carrying the fair-share rate at every re-rating
interval, arbiter revocation/charge events, and pool-scheduler job
admit/gang/run events.  The paper's headline numbers are *attribution*
claims — modeled seconds must be assignable to XLink hops, CXL switch
tiers, and tier-2 trunks — and this module is where the assignment is
recorded.

Design constraints, in order:

* **zero cost when disabled** — the module-level ``NULL_TRACER`` is a
  disabled singleton whose emit methods are no-ops; hot paths guard
  argument construction behind ``tracer.enabled`` so a tracer-less run
  executes the exact instruction stream it did before instrumentation
  (modeled clocks are never read *or* advanced by tracing: events are
  passive observations of clocks the subsystems already computed);
* **deterministic** — events carry only modeled quantities, so the
  same seed/trace produces a bit-identical event stream across runs,
  hosts, and ``Engine.local`` vs single-tenant-under-arbiter (the
  determinism suite in ``tests/test_obs.py`` pins this);
* **bounded** — events land in a fixed-capacity ring buffer ("flight
  recorder") with O(1) append: a million-step run keeps the most
  recent ``capacity`` events and counts the rest in ``dropped``
  instead of growing without bound.

Tracks are plain strings naming the timeline an event belongs to —
``"engine:a"``, ``"engine:a/requests"``, ``"link:spine->t2sw"``,
``"pool:arbiter"``, ``"pool:sched"``.  The Perfetto exporter
(``repro_torch.obs.export``) groups them into process/thread rows by the
prefix before the first ``":"``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# Chrome trace_event phase tags (the subset the exporter emits)
PH_SPAN = "X"          # complete event: ts + dur
PH_INSTANT = "i"       # point event
PH_COUNTER = "C"       # sampled value

# event categories (the ``cat`` field): one per subsystem surface, so
# viewers and reports can filter without parsing event names
CAT_REQUEST = "request"     # request lifecycle (submit..finish)
CAT_ENGINE = "engine"       # engine scheduling (prefill/decode steps)
CAT_KV = "kv"               # paging traffic (pause/spill/fetch/drop)
CAT_LINK = "link"           # per-transfer link occupancy
CAT_FABRIC = "fabric"       # whole-transfer spans on the transport
CAT_ARBITER = "arbiter"     # revocation / charge events
CAT_SCHED = "sched"         # pool scheduler job events


class Event(Tuple):
    """One trace event: an immutable tuple subclass so ring-buffer
    wraps can never corrupt a recorded event in place.

    Layout: ``(ph, cat, track, name, ts, dur, args)`` with ``ts``/
    ``dur`` in modeled seconds and ``args`` a (possibly empty) dict of
    JSON-serializable details.
    """

    __slots__ = ()

    def __new__(cls, ph: str, cat: str, track: str, name: str,
                ts: float, dur: float = 0.0,
                args: Optional[Dict[str, Any]] = None):
        return super().__new__(cls, (ph, cat, track, name, float(ts),
                                     float(dur), args or {}))

    @property
    def ph(self) -> str:
        return self[0]

    @property
    def cat(self) -> str:
        return self[1]

    @property
    def track(self) -> str:
        return self[2]

    @property
    def name(self) -> str:
        return self[3]

    @property
    def ts(self) -> float:
        return self[4]

    @property
    def dur(self) -> float:
        return self[5]

    @property
    def args(self) -> Dict[str, Any]:
        return self[6]


class Tracer:
    """Flight recorder: a bounded ring of typed events, O(1) append.

    ``capacity`` bounds resident events; once full, the oldest event is
    overwritten and ``dropped`` increments.  ``events()`` returns the
    surviving events oldest-first.  All emit methods are safe on the
    hot path; when profiling shows even the guarded calls matter, pass
    ``NULL_TRACER`` (or nothing) and they vanish behind ``enabled``.
    """

    enabled: bool = True

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError("tracer capacity must be positive")
        self.capacity = int(capacity)
        self._ring: List[Optional[Event]] = [None] * self.capacity
        self._next = 0              # next write position
        self._count = 0             # events ever recorded
        self.dropped = 0            # events overwritten by the ring

    # ---- recording -------------------------------------------------------
    def _append(self, ev: Event) -> None:
        i = self._next
        if self._ring[i] is not None:
            self.dropped += 1
        self._ring[i] = ev
        self._next = (i + 1) % self.capacity
        self._count += 1

    def span(self, track: str, name: str, ts: float, dur: float, *,
             cat: str = CAT_ENGINE, **args: Any) -> None:
        """A completed interval ``[ts, ts + dur]`` on ``track``."""
        self._append(Event(PH_SPAN, cat, track, name, ts, dur, args))

    def instant(self, track: str, name: str, ts: float, *,
                cat: str = CAT_ENGINE, **args: Any) -> None:
        """A point event at modeled time ``ts``."""
        self._append(Event(PH_INSTANT, cat, track, name, ts, 0.0, args))

    def counter(self, track: str, name: str, ts: float, value: float, *,
                cat: str = CAT_ENGINE) -> None:
        """A sampled value (renders as a counter track in Perfetto)."""
        self._append(Event(PH_COUNTER, cat, track, name, ts, 0.0,
                           {"value": value}))

    # ---- reading ---------------------------------------------------------
    def __len__(self) -> int:
        return min(self._count, self.capacity)

    @property
    def total_recorded(self) -> int:
        """Events ever emitted (including ones the ring dropped)."""
        return self._count

    def events(self) -> List[Event]:
        """Surviving events, oldest first (append order — subsystems
        emit at monotone modeled times per track, but tracks interleave
        by *emission* order, which is itself deterministic)."""
        if self._count <= self.capacity:
            return [e for e in self._ring[:self._next] if e is not None]
        return ([e for e in self._ring[self._next:] if e is not None]
                + [e for e in self._ring[:self._next] if e is not None])

    def tracks(self) -> List[str]:
        seen: Dict[str, None] = {}
        for e in self.events():
            seen.setdefault(e.track)
        return list(seen)

class NullTracer(Tracer):
    """The disabled tracer: every emit is a no-op and ``enabled`` is
    False so instrumentation sites can skip argument construction
    entirely.  A process-wide singleton (``NULL_TRACER``) is the
    default everywhere a tracer is threadable."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def span(self, *a: Any, **kw: Any) -> None:
        pass

    def instant(self, *a: Any, **kw: Any) -> None:
        pass

    def counter(self, *a: Any, **kw: Any) -> None:
        pass


NULL_TRACER = NullTracer()



def resolve(tracer: Optional[Tracer]) -> Tracer:
    """``tracer or NULL_TRACER`` with a type check close to the API
    boundary (a mis-passed registry or bool fails here, not deep in a
    hot loop)."""
    if tracer is None:
        return NULL_TRACER
    if not isinstance(tracer, Tracer):
        raise TypeError(f"expected a repro_torch.obs.Tracer, got {tracer!r}")
    return tracer
