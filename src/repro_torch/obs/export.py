"""Chrome/Perfetto ``trace_event`` export of a ``Tracer``'s events.

``write_chrome_trace`` / ``to_chrome_trace`` serialize the flight
recorder as Chrome trace_event JSON (the format Perfetto and
``chrome://tracing`` load directly).  Tracks become process/thread
rows: the prefix before the first ``":"`` picks the process
(``engine`` / ``link`` / ``fabric``), the full track string the
thread.  ``link_tier`` classifies a fabric link into its estate tier
for the link-occupancy spans the transport emits.

Timestamps: modeled seconds are exported as microseconds (``ts``/
``dur`` are µs in trace_event), keeping sub-microsecond modeled events
visible at Perfetto's default zoom.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.trace import PH_INSTANT, PH_SPAN, Tracer

_S_TO_US = 1e6

# link tiers of the scalepool estate, keyed off node kinds/names as
# built by ``fabric.Topology`` (from_inventory and the benchmark
# topologies use these conventions)
TIER_XLINK = "xlink-pod"        # accel <-> pod (scale-up XLink)
TIER_LEAF = "cxl-leaf"          # endpoint/pod <-> first switch tier
TIER_SPINE = "cxl-spine"        # switch <-> switch (coherence core)
TIER_TRUNK = "tier2-trunk"      # spine <-> capacity-fabric switch
TIER_NODE = "tier2-node"        # capacity switch <-> memory node
TIER_OTHER = "other"


def link_tier(link, topology=None) -> str:
    """Classify one fabric link into an estate tier.

    Accepts a ``fabric.topology.Link`` (preferred: endpoint kinds are
    authoritative) or a bare ``"src->dst"`` name (trace files carry
    only names; fall back to the naming conventions of
    ``Topology.from_inventory``)."""
    if hasattr(link, "src"):
        src, dst = link.src, link.dst
        kinds = topology.nodes if topology is not None else {}
    else:
        src, dst, kinds = *str(link).split("->", 1), {}

    def kind(n: str) -> str:
        if n in kinds:
            return kinds[n]
        for tag, k in (("accel:", "accel"), ("pod:", "pod"),
                       ("leaf:", "switch"), ("spine", "switch"),
                       ("t2sw", "switch"), ("mem:", "memory"),
                       ("sw", "switch")):
            if n.startswith(tag):
                return k
        return "endpoint"

    ks, kd = kind(src), kind(dst)
    if "accel" in (ks, kd):
        return TIER_XLINK
    if "t2sw" in (src, dst) and ks == kd == "switch":
        return TIER_TRUNK
    if "memory" in (ks, kd):
        return TIER_NODE
    if ks == kd == "switch":
        return TIER_SPINE
    if "switch" in (ks, kd):
        return TIER_LEAF
    return TIER_OTHER


# ---------------------------------------------------------------------------
# Chrome trace_event JSON
# ---------------------------------------------------------------------------

def _track_ids(tracks: List[str]) -> Dict[str, Tuple[int, int]]:
    """Stable (pid, tid) per track: pid by track-group prefix (before
    the first ':'), tid by track order within the group."""
    groups: Dict[str, List[str]] = {}
    for t in tracks:
        groups.setdefault(t.split(":", 1)[0], []).append(t)
    ids: Dict[str, Tuple[int, int]] = {}
    for pid, (group, members) in enumerate(sorted(groups.items()), start=1):
        for tid, track in enumerate(sorted(members), start=1):
            ids[track] = (pid, tid)
    return ids


def to_chrome_trace(tracer: Tracer, *,
                    extra_metadata: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The trace_event document as a dict (JSON Object Format:
    ``{"traceEvents": [...], ...}``), with one metadata block naming
    every track and recording flight-recorder losses."""
    events = tracer.events()
    ids = _track_ids([t for t in tracer.tracks()])
    out: List[Dict[str, Any]] = []
    for group in sorted({t.split(":", 1)[0] for t in ids}):
        pid = next(p for t, (p, _) in ids.items()
                   if t.split(":", 1)[0] == group)
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": group}})
    for track, (pid, tid) in sorted(ids.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": track}})
    for e in events:
        pid, tid = ids[e.track]
        d: Dict[str, Any] = {"ph": e.ph, "cat": e.cat, "name": e.name,
                             "pid": pid, "tid": tid,
                             "ts": e.ts * _S_TO_US}
        if e.ph == PH_SPAN:
            d["dur"] = e.dur * _S_TO_US
        if e.ph == PH_INSTANT:
            d["s"] = "t"                      # thread-scoped instant
        if e.args:
            d["args"] = dict(e.args)
        out.append(d)
    meta = {"recorder_capacity": tracer.capacity,
            "recorder_dropped": tracer.dropped,
            "events_recorded": tracer.total_recorded,
            "clock": "modeled-seconds (exported as us)"}
    if extra_metadata:
        meta.update(extra_metadata)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": meta}


def write_chrome_trace(tracer: Tracer, path: str, *,
                       extra_metadata: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    doc = to_chrome_trace(tracer, extra_metadata=extra_metadata)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
        f.write("\n")
    return doc

