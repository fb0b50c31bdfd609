"""Chrome/Perfetto ``trace_event`` export + per-link utilization report.

Two consumers of one flight recorder:

* ``write_chrome_trace`` / ``to_chrome_trace`` — serialize a
  ``Tracer``'s events as Chrome trace_event JSON (the format Perfetto
  and ``chrome://tracing`` load directly).  Tracks become
  process/thread rows: the prefix before the first ``":"`` picks the
  process (``engine`` / ``link`` / ``pool`` / ``fabric``), the full
  track string the thread, so a colocation run renders as one
  timeline row per tenant, per fabric link, and per pool actor.

* ``link_report`` — decompose a run's modeled seconds by fabric link
  (and link *tier*: XLink pod, CXL leaf, CXL spine, tier-2 trunk,
  tier-2 node): per-link busy seconds, utilization over the observed
  window, bytes carried, peak concurrent flows, and queueing delay
  (the contention-induced stretch of every transfer crossing the
  link), with each link's payload bytes by flow label.

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


def validate_trace_events(doc: Dict[str, Any]) -> List[str]:
    """Structural validation against the trace_event contract (the
    subset we emit).  Returns a list of problems — empty means the file
    loads in Perfetto/chrome://tracing.  Used by the determinism suite
    so exporter drift fails loudly."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, e in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M"):
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if "name" not in e:
            problems.append(f"{where}: missing name")
        if ph == "M":
            continue
        for key in ("pid", "tid", "ts"):
            if not isinstance(e.get(key), (int, float)):
                problems.append(f"{where}: {key} missing or non-numeric")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event needs dur >= 0, "
                                f"got {dur!r}")
        if "args" in e and not isinstance(e["args"], dict):
            problems.append(f"{where}: args not an object")
    try:
        json.dumps(doc)
    except TypeError as err:        # pragma: no cover - defensive
        problems.append(f"not JSON-serializable: {err}")
    return problems


# ---------------------------------------------------------------------------
# per-link utilization / queueing-delay report
# ---------------------------------------------------------------------------

def link_report(transport, *, window_s: Optional[float] = None
                ) -> Dict[str, Dict[str, Any]]:
    """Per-link decomposition of a run's modeled transfer seconds,
    straight from a ``fabric.Transport``'s link accounting (call
    ``transport.quiesce()`` first if in-flight tails should count).

    Per link: ``tier``, ``busy_s`` (seconds >= 1 flow crossed it),
    ``bytes`` carried, ``util`` (busy fraction of the observed
    window), ``mean_rate`` while busy, ``peak_flows``, and
    ``stretch_s`` — the queueing delay: summed contention-induced
    excess (actual minus solo duration) of every transfer whose route
    crossed the link, the time attribution the fig10 claims are made
    from."""
    topo = transport.topology
    window = window_s if window_s is not None else transport.now
    out: Dict[str, Dict[str, Any]] = {}
    for name, link in sorted(topo.links.items()):
        busy = transport.link_busy_s.get(name, 0.0)
        nbytes = transport.link_bytes.get(name, 0.0)
        out[name] = {
            "tier": link_tier(link, topo),
            "capacity": link.capacity,
            "busy_s": busy,
            "bytes": nbytes,
            "util": busy / window if window > 0 else 0.0,
            "mean_rate": nbytes / busy if busy > 0 else 0.0,
            "peak_flows": transport.link_peak_flows.get(name, 0),
            "stretch_s": transport.link_stretch_s.get(name, 0.0),
            # payload bytes by flow label ("serve:a", "train:job0", ...)
            # — who occupied the link; empty for unlabeled traffic
            "by_label": dict(transport.link_label_bytes.get(name, {})),
        }
    return out


def tier_report(links: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Fold a ``link_report`` by estate tier — the "where did the
    modeled seconds go" table (XLink pod / CXL leaf / spine / tier-2
    trunk / tier-2 node)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, row in links.items():
        t = out.setdefault(row["tier"], {"links": 0, "busy_s": 0.0,
                                         "bytes": 0.0, "stretch_s": 0.0,
                                         "peak_flows": 0, "max_util": 0.0})
        t["links"] += 1
        t["busy_s"] += row["busy_s"]
        t["bytes"] += row["bytes"]
        t["stretch_s"] += row["stretch_s"]
        t["peak_flows"] = max(t["peak_flows"], row["peak_flows"])
        t["max_util"] = max(t["max_util"], row["util"])
    return out


def format_link_report(links: Dict[str, Dict[str, Any]], *,
                       window_s: Optional[float] = None) -> str:
    """Human-readable report (also what ``scripts/trace_report.py``
    prints): per-link rows sorted busiest-first, then the tier fold."""
    lines = []
    hdr = (f"{'link':34s} {'tier':12s} {'busy_s':>10s} {'util':>7s} "
           f"{'GB':>8s} {'peak':>5s} {'stretch_s':>10s}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    rows = sorted(links.items(), key=lambda kv: -kv[1]["busy_s"])
    for name, r in rows:
        lines.append(f"{name:34s} {r['tier']:12s} {r['busy_s']:10.4f} "
                     f"{r['util']:6.1%} {r['bytes'] / 1e9:8.3f} "
                     f"{r['peak_flows']:5d} {r['stretch_s']:10.4f}")
    lines.append("")
    lines.append("by tier:")
    for tier, r in sorted(tier_report(links).items(),
                          key=lambda kv: -kv[1]["busy_s"]):
        lines.append(f"  {tier:12s} links={r['links']:3d} "
                     f"busy={r['busy_s']:.4f}s "
                     f"max_util={r['max_util']:.1%} "
                     f"stretch={r['stretch_s']:.4f}s")
    if window_s is not None:
        lines.append(f"window: {window_s:.4f} modeled seconds")
    return "\n".join(lines)


def link_report_from_trace(doc: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Reconstruct the per-link report from an exported trace file
    alone (no live ``Transport``): link-occupancy spans carry bytes,
    solo duration, and tier in their args; busy seconds are the union
    of each link track's span intervals (concurrent flows overlap — a
    link is busy once, not once per flow)."""
    per_track: Dict[str, List[Tuple[float, float, Dict]]] = {}
    names: Dict[int, Dict[int, str]] = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names.setdefault(e["pid"], {})[e["tid"]] = e["args"]["name"]
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        track = names.get(e.get("pid"), {}).get(e.get("tid"), "")
        if not track.startswith("link:"):
            continue
        per_track.setdefault(track[len("link:"):], []).append(
            (e["ts"] / _S_TO_US, (e["ts"] + e["dur"]) / _S_TO_US,
             e.get("args", {})))
    out: Dict[str, Dict[str, Any]] = {}
    for link, spans in sorted(per_track.items()):
        spans.sort(key=lambda sp: (sp[0], sp[1]))
        busy = 0.0
        cur_start, cur_end = spans[0][0], spans[0][1]
        peak, active = 1, []
        by_label: Dict[str, float] = {}
        for s, t, a in spans:
            if s > cur_end:
                busy += cur_end - cur_start
                cur_start, cur_end = s, t
            else:
                cur_end = max(cur_end, t)
            active = [e for e in active if e > s] + [t]
            peak = max(peak, len(active))
            if a.get("label") is not None:
                by_label[a["label"]] = (by_label.get(a["label"], 0.0)
                                        + a.get("bytes", 0.0))
        busy += cur_end - cur_start
        args0 = spans[0][2]
        out[link] = {
            "tier": args0.get("tier", link_tier(link)),
            "capacity": args0.get("capacity", 0.0),
            "busy_s": busy,
            "bytes": sum(a.get("bytes", 0.0) for _, _, a in spans),
            "util": 0.0,            # window unknown from spans alone
            "mean_rate": 0.0,
            "peak_flows": peak,
            "stretch_s": sum(max(0.0, (t - s) - a.get("solo_s", t - s))
                             for s, t, a in spans),
            "by_label": by_label,
        }
    window = max((t for spans in per_track.values()
                  for _, t, _ in spans), default=0.0)
    for r in out.values():
        r["util"] = r["busy_s"] / window if window > 0 else 0.0
        r["mean_rate"] = (r["bytes"] / r["busy_s"]
                          if r["busy_s"] > 0 else 0.0)
    return out
