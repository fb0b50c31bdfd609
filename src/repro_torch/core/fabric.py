"""Fabric model for ScalePool: links, switches, topologies.

This module implements the paper's §6 methodology: "link latency derived
from flit sizes, PHY layer characteristics, and packetization and queuing
behaviors at both link and transaction layers. Switch latencies were
determined using empirical measurements ... factoring in the hop counts
required for endpoint-to-endpoint communication."

Everything here is a *pure-python analytical model*.  This copy keeps
the CXL constants the serving engine prices tier-2 transfers with.

Units: bytes, seconds, GB/s (1e9 bytes/s). All latencies stored in seconds.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass
from typing import Optional

NS = 1e-9
US = 1e-6
MS = 1e-3
GB = 1e9


class Protocol(enum.Enum):
    """Interconnect protocol families discussed in the paper (Table 1)."""

    NVLINK = "nvlink"          # XLink: proprietary PHY, 48-272B flits
    UALINK = "ualink"          # XLink: Ethernet PHY, fixed 640B flits
    CXL = "cxl"                # PCIe PHY, 256B PBR flits, cache coherent
    INFINIBAND = "infiniband"  # scale-out RDMA baseline
    PCIE = "pcie"              # host attach
    DDR = "ddr"                # plain CPU-attached memory channel


@dataclass(frozen=True)
class LinkSpec:
    """A point-to-point link: PHY + link-layer framing characteristics.

    ``flit_bytes``      - wire size of one flit.
    ``flit_payload``    - payload bytes carried per flit (flit minus CRC,
                          headers, sequence numbers).  Packetization
                          efficiency = flit_payload / flit_bytes.
    ``phy_latency``     - one-way PHY+SerDes propagation latency.
    ``sw_overhead``     - *per-transfer* software involvement.  Zero for
                          hardware-coherent fabrics (CXL) and XLink DMA;
                          microseconds for RDMA verbs (QP doorbell, memory
                          registration amortized, completion polling,
                          communicator synchronization).
    """

    name: str
    protocol: Protocol
    bandwidth: float            # GB/s per direction, per link
    phy_latency: float          # seconds
    flit_bytes: int
    flit_payload: int
    sw_overhead: float = 0.0    # seconds per transfer (software stack)
    # RDMA-style stacks re-enter software per posted work request; large
    # transfers are chunked into quanta that each pay (part of) the
    # overhead.  None = fully offloaded hardware DMA (XLink, CXL).
    message_quantum: Optional[int] = None

    @property
    def efficiency(self) -> float:
        return self.flit_payload / self.flit_bytes

    def wire_bytes(self, payload: int) -> int:
        """Bytes actually serialized on the wire for ``payload`` bytes."""
        if payload <= 0:
            return 0
        nflits = math.ceil(payload / self.flit_payload)
        return nflits * self.flit_bytes

    def serialization_time(self, payload: int) -> float:
        return self.wire_bytes(payload) / (self.bandwidth * GB)


@dataclass(frozen=True)
class SwitchSpec:
    """A switching element.  ``hop_latency`` is port-to-port measured
    latency (the paper uses silicon-prototype measurements for CXL)."""

    name: str
    hop_latency: float          # seconds per traversal
    radix: int                  # ports
    per_port_bandwidth: float   # GB/s


class TopologyKind(enum.Enum):
    SINGLE_HOP = "single_hop"       # XLink one-stage Clos / full mesh
    MULTI_CLOS = "multi_level_clos" # CXL cascaded switches
    TORUS3D = "3d_torus"
    DRAGONFLY = "dragonfly"


@dataclass(frozen=True)
class Topology:
    """Endpoint-count → hop-count model for each fabric shape.

    The paper's CXL fabrics use PBR + switch cascading to build
    multi-level Clos / 3D-torus / DragonFly structures; XLink is
    restricted to single-hop.
    """

    kind: TopologyKind
    endpoints: int
    switch: SwitchSpec
    # Oversubscription factor >= 1.0: ratio of ingress to uplink capacity
    # at each level (1.0 = full bisection).
    oversubscription: float = 1.0

    def hops(self) -> int:
        """Worst-case switch traversals endpoint-to-endpoint."""
        n, r = self.endpoints, self.switch.radix
        if self.kind == TopologyKind.SINGLE_HOP:
            return 1
        if self.kind == TopologyKind.MULTI_CLOS:
            # Folded Clos: levels = ceil(log_{r/2}(n)); up-down path
            # traverses (2*levels - 1) switches.
            if n <= r:
                return 1
            levels = max(1, math.ceil(math.log(n) / math.log(max(2, r // 2))))
            return 2 * levels - 1
        if self.kind == TopologyKind.TORUS3D:
            # average hop distance ~ 3 * (n^(1/3)) / 4 per dimension sum
            side = max(1, round(n ** (1.0 / 3.0)))
            return max(1, 3 * side // 4)
        if self.kind == TopologyKind.DRAGONFLY:
            # canonical minimal route: local - global - local
            return 3 if n > self.switch.radix else 1
        raise ValueError(self.kind)

    def switching_latency(self) -> float:
        return self.hops() * self.switch.hop_latency

    def effective_bandwidth(self, link: LinkSpec) -> float:
        """Per-endpoint sustainable bandwidth through the fabric (GB/s)."""
        return min(link.bandwidth, self.switch.per_port_bandwidth) / self.oversubscription


@dataclass(frozen=True)
class FabricSpec:
    """A complete fabric: link + topology (+ queuing model).

    ``load`` in [0,1) feeds an M/D/1-style queuing inflation factor
    ``1 + load/(2*(1-load))`` applied to serialization time — the
    "queuing behaviors at link and transaction layers" of §6.
    """

    name: str
    link: LinkSpec
    topology: Topology
    load: float = 0.30

    def queuing_factor(self) -> float:
        rho = min(max(self.load, 0.0), 0.95)
        return 1.0 + rho / (2.0 * (1.0 - rho))

    def transfer_time(self, payload_bytes: int, *, contention: float = 1.0) -> float:
        """End-to-end one-way time for a single message of ``payload_bytes``.

        contention >= 1.0 divides effective bandwidth (e.g. ring steps where
        multiple flows share a link).
        """
        link = self.link
        bw = self.topology.effective_bandwidth(link) / contention
        wire = link.wire_bytes(payload_bytes)
        serialization = wire / (bw * GB) * self.queuing_factor()
        if link.message_quantum and payload_bytes > link.message_quantum:
            # per-quantum software involvement (work-request posting,
            # completion handling) — partially pipelined, so charge it as
            # added per-byte resistance rather than a serial stall.
            serialization += payload_bytes * (link.sw_overhead / link.message_quantum)
        return (
            link.sw_overhead
            + link.phy_latency
            + self.topology.switching_latency()
            + serialization
        )

    def latency(self) -> float:
        """Zero-byte message latency (the 'link latency' of Table 1)."""
        return self.link.sw_overhead + self.link.phy_latency + self.topology.switching_latency()

    def bandwidth(self) -> float:
        """Effective large-message bandwidth (GB/s) incl. flit efficiency
        and (for RDMA) per-quantum software overhead."""
        base_bps = (
            self.topology.effective_bandwidth(self.link)
            * self.link.efficiency
            / self.queuing_factor()
            * GB
        )
        time_per_byte = 1.0 / base_bps
        if self.link.message_quantum:
            time_per_byte += self.link.sw_overhead / self.link.message_quantum
        return 1.0 / time_per_byte / GB


# ---------------------------------------------------------------------------
# Catalog: concrete link/switch constants.
#
# Source: paper Table 1 + §2: CXL 3.x 256B PBR flits on PCIe6 x16
# (~121 GB/s/dir).
# ---------------------------------------------------------------------------

CXL3 = LinkSpec(
    name="CXL 3.x x16",
    protocol=Protocol.CXL,
    bandwidth=121.0,            # PCIe6 x16 per direction
    phy_latency=150 * NS,
    flit_bytes=256,
    flit_payload=236,
    sw_overhead=0.0,            # hardware coherent: no software on data path
)

# Capacity-oriented CXL (tier-2): CXL.io/mem bulk path, §5.
CXL_CAPACITY = dataclasses.replace(CXL3, name="CXL capacity-oriented", phy_latency=180 * NS)

CXL_SWITCH = SwitchSpec("CXL PBR switch", hop_latency=250 * NS, radix=64, per_port_bandwidth=121.0)


def tier2_memory_fabric(n_endpoints: int) -> FabricSpec:
    """Dedicated capacity-oriented CXL fabric to CPU-less memory nodes (§5)."""
    topo = Topology(TopologyKind.MULTI_CLOS, endpoints=n_endpoints, switch=CXL_SWITCH)
    return FabricSpec(name=f"Tier2-CXL x{n_endpoints}", link=CXL_CAPACITY, topology=topo)


# ---------------------------------------------------------------------------
# Thin re-export shim for the routed-fabric package.  The *routed* graph
# (endpoint topology, min-hop routes, contended link sharing) lives in
# ``repro_torch.fabric``; this module keeps the per-link analytical models it
# builds on.  ``Topology`` here remains the endpoint-count -> hop-count
# closed form above; the node/edge graph is exposed as ``TopologyGraph``.
# Lazy to avoid a core <-> fabric import cycle.
# ---------------------------------------------------------------------------

def __getattr__(name: str):
    if name in ("Transport", "Route", "Link", "TopologyGraph"):
        import repro_torch.fabric as _routed
        return {"Transport": _routed.Transport, "Route": _routed.Route,
                "Link": _routed.Link,
                "TopologyGraph": _routed.Topology}[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
