"""Routed fabric topology: the graph tier-2 transfers are priced on.

``Link``
    One *directed* capacity-carrying edge between two nodes (full
    duplex fabrics are two ``Link``s), wrapping a ``core.fabric.LinkSpec``
    for the PHY identity.  ``capacity`` is the payload rate (bytes/s,
    flit efficiency and queuing already folded in); ``latency`` the
    fixed traversal time.

``Route``
    A hop list of ``Link``s from ``Topology.route(src, dst)``.
    Contended pricing (several in-flight transfers fair-sharing each
    link) lives in ``repro_torch.fabric.transport.Transport``.

``Topology``
    The node/edge graph with min-hop routing.  ``Topology.degenerate``
    builds the 1-link graph the ``ServeCostModel`` facade runs on.

Units follow ``core.fabric``: bytes, seconds, bytes/s.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.fabric import GB, LinkSpec, Protocol

# node-kind tags (informational; routing treats all nodes alike)
ACCEL = "accel"
POD = "pod"
SWITCH = "switch"
MEMORY = "memory"
ENDPOINT = "endpoint"


@dataclass(frozen=True)
class Link:
    """One directed edge of the fabric graph.

    ``capacity`` is the sustainable *payload* rate (bytes/s) the link
    can serialize — flit efficiency and queuing inflation already
    folded in, i.e. the ``FabricSpec.bandwidth()`` number, so a solo
    transfer of ``n`` bytes serializes in ``n / capacity`` seconds.
    ``latency`` is the fixed one-way traversal time (PHY + switch hop
    + any per-transfer software overhead).
    """

    name: str
    src: str
    dst: str
    spec: LinkSpec
    capacity: float             # payload bytes/s
    latency: float              # seconds per traversal

    def __post_init__(self):
        if self.capacity <= 0:
            raise ValueError(f"link {self.name}: capacity must be positive")
        if self.latency < 0:
            raise ValueError(f"link {self.name}: negative latency")


@dataclass(frozen=True)
class Route:
    """An ordered hop list of ``Link``s from one endpoint to another."""

    links: Tuple[Link, ...]

    def __post_init__(self):
        if not self.links:
            raise ValueError("empty route")
        for a, b in zip(self.links, self.links[1:]):
            if a.dst != b.src:
                raise ValueError(f"route discontinuity: {a.name} ends at "
                                 f"{a.dst!r} but {b.name} starts at {b.src!r}")

    @property
    def src(self) -> str:
        return self.links[0].src

    @property
    def dst(self) -> str:
        return self.links[-1].dst

    @property
    def hops(self) -> int:
        return len(self.links)

    def latency(self) -> float:
        """Zero-byte end-to-end latency (sum of hop latencies)."""
        return sum(l.latency for l in self.links)

    @property
    def bottleneck_bw(self) -> float:
        """Payload bytes/s of the slowest hop — the solo transfer rate
        (hops pipeline flit-by-flit, so serialization is paid once at
        the bottleneck, while latency accumulates per hop)."""
        return min(l.capacity for l in self.links)


class Topology:
    """The routed fabric graph.  Nodes are string ids tagged with a
    kind; links are directed.  ``connect`` adds the two directions of
    a full-duplex link as independent capacity (per-direction
    bandwidth, matching ``LinkSpec.bandwidth``'s convention)."""

    def __init__(self, name: str = "fabric"):
        self.name = name
        self.nodes: Dict[str, str] = {}            # id -> kind
        self.links: Dict[str, Link] = {}           # name -> Link
        self._adj: Dict[str, List[Link]] = {}      # src -> outgoing links
        self._route_cache: Dict[Tuple[str, str], Route] = {}

    # ---- construction ----------------------------------------------------
    def add_node(self, node: str, kind: str = ENDPOINT) -> str:
        if node in self.nodes and self.nodes[node] != kind:
            raise ValueError(f"node {node!r} already exists as "
                             f"{self.nodes[node]!r}")
        self.nodes[node] = kind
        self._adj.setdefault(node, [])
        return node

    def add_link(self, src: str, dst: str, spec: LinkSpec, *,
                 capacity: float, latency: float,
                 name: Optional[str] = None) -> Link:
        """Add one *directed* edge."""
        for n in (src, dst):
            if n not in self.nodes:
                raise KeyError(f"unknown node {n!r} (add_node first)")
        link = Link(name or f"{src}->{dst}", src, dst, spec,
                    capacity, latency)
        if link.name in self.links:
            raise ValueError(f"duplicate link {link.name!r}")
        self.links[link.name] = link
        self._adj[src].append(link)
        self._route_cache.clear()
        return link

    def connect(self, a: str, b: str, spec: LinkSpec, *,
                capacity: float, latency: float) -> Tuple[Link, Link]:
        """Full-duplex: both directions, each with its own capacity."""
        return (self.add_link(a, b, spec, capacity=capacity, latency=latency),
                self.add_link(b, a, spec, capacity=capacity, latency=latency))

    # ---- routing ---------------------------------------------------------
    def route(self, src: str, dst: str) -> Route:
        """Min-hop route (BFS; deterministic neighbor order = insertion
        order, so equal-hop ties resolve to the earliest-added links)."""
        key = (src, dst)
        cached = self._route_cache.get(key)
        if cached is not None:
            return cached
        for n in (src, dst):
            if n not in self.nodes:
                raise KeyError(f"unknown node {n!r}")
        if src == dst:
            raise ValueError(f"route {src!r} -> itself")
        prev: Dict[str, Link] = {}
        seen = {src}
        q = deque([src])
        while q:
            cur = q.popleft()
            if cur == dst:
                break
            for link in self._adj[cur]:
                if link.dst not in seen:
                    seen.add(link.dst)
                    prev[link.dst] = link
                    q.append(link.dst)
        if dst not in prev:
            raise ValueError(f"no route {src!r} -> {dst!r} in {self.name}")
        hops: List[Link] = []
        cur = dst
        while cur != src:
            link = prev[cur]
            hops.append(link)
            cur = link.src
        route = Route(tuple(reversed(hops)))
        self._route_cache[key] = route
        return route

    # ---- canned shapes ---------------------------------------------------
    @classmethod
    def degenerate(cls, bandwidth: float, latency: float, *,
                   name: str = "degenerate",
                   spec: Optional[LinkSpec] = None) -> "Topology":
        """The 1-link graph (``src`` -> ``dst``) the legacy
        ``ServeCostModel`` facade runs on: a solo transfer of ``n``
        bytes takes exactly ``latency + n / bandwidth`` seconds."""
        topo = cls(name)
        topo.add_node("src", ENDPOINT)
        topo.add_node("dst", MEMORY)
        lk = spec or dataclasses.replace(
            _NULL_SPEC, name=name, bandwidth=bandwidth / GB)
        topo.connect("src", "dst", lk, capacity=bandwidth, latency=latency)
        return topo

# placeholder PHY identity for synthetic/degenerate links (payload ==
# wire: efficiency 1.0, no software on the data path)
_NULL_SPEC = LinkSpec(name="modeled", protocol=Protocol.CXL,
                      bandwidth=1.0, phy_latency=0.0,
                      flit_bytes=1, flit_payload=1)
