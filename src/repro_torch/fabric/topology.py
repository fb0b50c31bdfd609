"""Routed fabric topology: the graph the whole repo prices transfers on.

Until now every layer carried its own private copy of the fabric's
price list: ``ServeCostModel.swap_s`` handed each tenant the full
tier-2 bandwidth, ``pool.allocator`` reserved per-node bandwidth
scalars, and the collective models in ``core.costmodel`` saw a bare
``FabricSpec`` with no switch hierarchy.  Cross-consumer contention on
the *shared* hierarchical CXL fabric — the phenomenon the paper's
tier-2 claim lives or dies on — was structurally unrepresentable.

This module centralizes the structure once:

``Link``
    One *directed* capacity-carrying edge between two nodes (full
    duplex fabrics are two ``Link``s).  Wraps an existing
    ``core.fabric.LinkSpec`` for the PHY/flit identity and adds the
    instance quantities a router needs: effective payload capacity
    (bytes/s, flit efficiency and queuing already folded in, exactly
    ``FabricSpec.bandwidth()`` semantics) and fixed traversal latency.

``Route``
    A hop list of ``Link``s from ``Topology.route(src, dst)``.  Prices
    a *solo* transfer with ``transfer_time(nbytes)`` — the same
    contract as ``FabricSpec.transfer_time``, so a ``Route`` can be
    passed anywhere ``core.costmodel`` expects a fabric.  Contended
    pricing (several in-flight transfers fair-sharing each link) lives
    in ``repro_torch.fabric.transport.Transport``.

``Topology``
    The node/edge graph: accelerators, XLink pods, CXL switch tiers
    (leaf / spine / the capacity-fabric switch) and tier-2 memory
    nodes.  ``Topology.from_inventory`` derives it from a
    ``pool.inventory.Inventory``; ``Topology.degenerate`` builds the
    1-link graph the legacy ``ServeCostModel`` facade runs on.

Units follow ``core.fabric``: bytes, seconds, bytes/s.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.fabric import GB, FabricSpec, LinkSpec, Protocol

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

    @property
    def specs(self) -> Tuple[LinkSpec, ...]:
        """The underlying ``core.fabric.LinkSpec`` per hop."""
        return tuple(l.spec for l in self.links)

    def latency(self) -> float:
        """Zero-byte end-to-end latency (sum of hop latencies)."""
        return sum(l.latency for l in self.links)

    @property
    def bottleneck_bw(self) -> float:
        """Payload bytes/s of the slowest hop — the solo transfer rate
        (hops pipeline flit-by-flit, so serialization is paid once at
        the bottleneck, while latency accumulates per hop)."""
        return min(l.capacity for l in self.links)

    def transfer_time(self, nbytes: float, *, contention: float = 1.0
                      ) -> float:
        """Solo end-to-end time — the ``FabricSpec.transfer_time``
        contract, so a ``Route`` drops into ``core.costmodel``
        collectives wherever a fabric is expected.  ``contention``
        divides the bottleneck bandwidth (static flow counting); for
        *dynamic* contention between actual in-flight transfers use
        ``Transport.begin_transfer``."""
        if nbytes <= 0:
            return self.latency()
        return self.latency() + nbytes / (self.bottleneck_bw / contention)

    # alias matching FabricSpec's observability surface
    def bandwidth(self) -> float:
        """Effective end-to-end bandwidth in GB/s (FabricSpec parity)."""
        return self.bottleneck_bw / GB


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

    def nodes_of_kind(self, kind: str) -> List[str]:
        return [n for n, k in self.nodes.items() if k == kind]

    def describe(self) -> str:
        kinds: Dict[str, int] = {}
        for k in self.nodes.values():
            kinds[k] = kinds.get(k, 0) + 1
        parts = ", ".join(f"{v} {k}" for k, v in sorted(kinds.items()))
        return f"{self.name}: {parts}, {len(self.links)} directed links"

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

    @classmethod
    def from_fabric_spec(cls, fabric: FabricSpec, *,
                         name: Optional[str] = None) -> "Topology":
        """Collapse a whole ``FabricSpec`` (link + topology + queuing)
        into one equivalent routed link: capacity is the spec's
        effective large-message bandwidth, latency its zero-byte
        latency — so the 1-link route's ``transfer_time`` matches
        ``FabricSpec.transfer_time`` for flit-aligned payloads."""
        return cls.degenerate(fabric.bandwidth() * GB, fabric.latency(),
                              name=name or fabric.name, spec=fabric.link)

    @classmethod
    def from_inventory(cls, inv, *, accels: bool = False,
                       tier2_trunk_bw: float = 0.0) -> "Topology":
        """Build the estate graph from a ``pool.inventory.Inventory``.

        Shape (scalepool): ``accel:<p>.<i>`` (optional) -- XLink -->
        ``pod:<p>`` -- coherence CXL --> ``leaf:<l>`` --> ``spine`` -->
        ``t2sw`` (capacity-fabric switch) --> ``mem:<k>``.  Baseline
        inventories (no tier-2 fabric) stop at the spine (IB core).

        ``tier2_trunk_bw``: capacity of the shared spine->t2sw trunk in
        bytes/s; 0 derives full bisection (sum of memory-node
        bandwidths), i.e. the trunk never binds before the nodes.  An
        ``Inventory.tier2_trunk_bw`` field, when positive, is the
        default — the knob an oversubscribed capacity fabric turns.
        """
        topo = cls(f"estate[{inv.interconnect}]")
        inter = inv.inter_fabric
        leaf_lat = inter.topology.switch.hop_latency + inter.link.phy_latency
        topo.add_node("spine", SWITCH)
        leaves = sorted({inv.leaf_of(p.id) for p in inv.pods})
        for l in leaves:
            topo.add_node(f"leaf:{l}", SWITCH)
            pods_on = [p for p in inv.pods if inv.leaf_of(p.id) == l]
            up = sum(inter.bandwidth() * GB * p.n_accels for p in pods_on)
            topo.connect(f"leaf:{l}", "spine", inter.link,
                         capacity=up / inter.topology.oversubscription,
                         latency=leaf_lat)
        for p in inv.pods:
            topo.add_node(f"pod:{p.id}", POD)
            # pod uplink into its leaf: one inter-fabric port per accel
            topo.connect(f"pod:{p.id}", f"leaf:{inv.leaf_of(p.id)}",
                         inter.link,
                         capacity=inter.bandwidth() * GB * p.n_accels,
                         latency=inter.link.sw_overhead + leaf_lat)
            if accels:
                pf = p.fabric
                for i in p.accel_ids():
                    a = topo.add_node(f"accel:{p.id}.{i}", ACCEL)
                    topo.connect(a, f"pod:{p.id}", pf.link,
                                 capacity=pf.bandwidth() * GB,
                                 latency=pf.latency())
        t2 = inv.tier2_fabric
        if t2 is not None and inv.memory_nodes:
            topo.add_node("t2sw", SWITCH)
            node_bw = [m.bandwidth or t2.bandwidth() * GB
                       for m in inv.memory_nodes]
            trunk = (tier2_trunk_bw
                     or getattr(inv, "tier2_trunk_bw", 0.0)
                     or float(sum(node_bw)))
            topo.connect("spine", "t2sw", t2.link, capacity=trunk,
                         latency=t2.topology.switch.hop_latency)
            for m, bw in zip(inv.memory_nodes, node_bw):
                topo.add_node(f"mem:{m.id}", MEMORY)
                topo.connect("t2sw", f"mem:{m.id}", t2.link,
                             capacity=bw, latency=t2.link.phy_latency)
        return topo


# placeholder PHY identity for synthetic/degenerate links (payload ==
# wire: efficiency 1.0, no software on the data path)
_NULL_SPEC = LinkSpec(name="modeled", protocol=Protocol.CXL,
                      bandwidth=1.0, phy_latency=0.0,
                      flit_bytes=1, flit_payload=1)
