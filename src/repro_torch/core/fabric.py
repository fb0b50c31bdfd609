"""Fabric model for ScalePool: links, switches, topologies.

This module implements the paper's §6 methodology: "link latency derived
from flit sizes, PHY layer characteristics, and packetization and queuing
behaviors at both link and transaction layers. Switch latencies were
determined using empirical measurements ... factoring in the hop counts
required for endpoint-to-endpoint communication."

Everything here is a *pure-python analytical model*: a copy of the
reference's, which the pool inventory, the routed estate graph and the
serving engine's tier-2 pricing build on.

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
# Sources: paper Table 1 + §2 (UALink 100 GB/s/port sub-us, NVLink <500ns,
# flit sizes 640B / 48-272B), CXL 3.x 256B PBR flits on PCIe6 x16
# (~121 GB/s/dir), NDR InfiniBand 400 Gb/s (~50 GB/s).  RDMA software
# overhead models verbs posting + completion + communicator synchronization
# (the paper's "software interventions are inevitable").
# ---------------------------------------------------------------------------

NVLINK5 = LinkSpec(
    name="NVLink 5.0",
    protocol=Protocol.NVLINK,
    bandwidth=900.0,            # GB/s per GPU direction (18 links x 50GB/s)
    phy_latency=300 * NS,
    flit_bytes=272,
    flit_payload=256,
    sw_overhead=0.0,
)

UALINK200 = LinkSpec(
    name="UALink 200G",
    protocol=Protocol.UALINK,
    bandwidth=100.0,            # GB/s per port
    phy_latency=600 * NS,       # sub-microsecond, Ethernet PHY
    flit_bytes=640,
    flit_payload=576,
    sw_overhead=0.0,
)

CXL3 = LinkSpec(
    name="CXL 3.x x16",
    protocol=Protocol.CXL,
    bandwidth=121.0,            # PCIe6 x16 per direction
    phy_latency=150 * NS,
    flit_bytes=256,
    flit_payload=236,
    sw_overhead=0.0,            # hardware coherent: no software on data path
)

# Coherence-centric CXL (tier-1 glue): trimmed flit processing, §5.
CXL_COHERENCE = dataclasses.replace(CXL3, name="CXL coherence-centric", phy_latency=100 * NS)

# Capacity-oriented CXL (tier-2): CXL.io/mem bulk path, §5.
CXL_CAPACITY = dataclasses.replace(CXL3, name="CXL capacity-oriented", phy_latency=180 * NS)

INFINIBAND_NDR = LinkSpec(
    name="InfiniBand NDR",
    protocol=Protocol.INFINIBAND,
    bandwidth=50.0,             # 400 Gb/s
    phy_latency=1.0 * US,       # end-to-end NIC-to-NIC port latency
    flit_bytes=4096 + 66,       # MTU-sized packets + headers
    flit_payload=4096,
    sw_overhead=6.0 * US,       # RDMA verbs + sync across communicators
    message_quantum=512 * 1024, # collective-library pipeline slice
)

PCIE5_HOST = LinkSpec(
    name="PCIe5 x16 host",
    protocol=Protocol.PCIE,
    bandwidth=63.0,
    phy_latency=400 * NS,
    flit_bytes=256,
    flit_payload=224,
    sw_overhead=0.0,
)

DDR5_LOCAL = LinkSpec(
    name="DDR5 CPU-attached",
    protocol=Protocol.DDR,
    bandwidth=307.0,            # 8 channels DDR5-4800
    phy_latency=90 * NS,
    flit_bytes=64,
    flit_payload=64,
    sw_overhead=0.0,
)

NVSWITCH = SwitchSpec("NVSwitch", hop_latency=100 * NS, radix=72, per_port_bandwidth=900.0)
UASWITCH = SwitchSpec("UALink switch", hop_latency=150 * NS, radix=72, per_port_bandwidth=100.0)
CXL_SWITCH = SwitchSpec("CXL PBR switch", hop_latency=250 * NS, radix=64, per_port_bandwidth=121.0)
IB_SWITCH = SwitchSpec("IB NDR switch", hop_latency=300 * NS, radix=64, per_port_bandwidth=50.0)


def xlink_cluster_fabric(n_accel: int = 72, link: LinkSpec = NVLINK5) -> FabricSpec:
    """Intra-cluster XLink fabric: one-stage switched, rack scale (§4)."""
    switch = NVSWITCH if link.protocol == Protocol.NVLINK else UASWITCH
    topo = Topology(TopologyKind.SINGLE_HOP, endpoints=n_accel, switch=switch)
    return FabricSpec(name=f"XLink[{link.name}]x{n_accel}", link=link, topology=topo)


def cxl_fabric(
    n_endpoints: int,
    kind: TopologyKind = TopologyKind.MULTI_CLOS,
    link: LinkSpec = CXL3,
    oversubscription: float = 1.0,
) -> FabricSpec:
    """Inter-cluster hierarchical CXL fabric (§4: Clos/3D-torus/DragonFly)."""
    topo = Topology(kind, endpoints=n_endpoints, switch=CXL_SWITCH,
                    oversubscription=oversubscription)
    return FabricSpec(name=f"CXL[{kind.value}]x{n_endpoints}", link=link, topology=topo)


def infiniband_fabric(n_endpoints: int, oversubscription: float = 1.0) -> FabricSpec:
    """Scale-out RDMA fabric (the paper's baseline inter-cluster path)."""
    topo = Topology(TopologyKind.MULTI_CLOS, endpoints=n_endpoints,
                    switch=IB_SWITCH, oversubscription=oversubscription)
    return FabricSpec(name=f"IB[NDR]x{n_endpoints}", link=INFINIBAND_NDR, topology=topo)


def tier2_memory_fabric(n_endpoints: int) -> FabricSpec:
    """Dedicated capacity-oriented CXL fabric to CPU-less memory nodes (§5)."""
    topo = Topology(TopologyKind.MULTI_CLOS, endpoints=n_endpoints, switch=CXL_SWITCH)
    return FabricSpec(name=f"Tier2-CXL x{n_endpoints}", link=CXL_CAPACITY, topology=topo)


@dataclass(frozen=True)
class MemoryTierSpec:
    """A memory tier as seen from one accelerator (§5)."""

    name: str
    capacity_bytes: float            # per accelerator-visible pool
    access_latency: float            # seconds, small-granule access
    bandwidth: float                 # GB/s streaming
    sw_overhead: float = 0.0         # software-managed copies, page faults

    def access_time(self, nbytes: int) -> float:
        return self.sw_overhead + self.access_latency + nbytes / (self.bandwidth * GB)


def hbm_tier(capacity_gb: float = 192.0) -> MemoryTierSpec:
    # GB200-class accelerator HBM3e
    return MemoryTierSpec("HBM(local)", capacity_gb * GB, 120 * NS, 8000.0)


def cluster_xlink_tier(fabric: FabricSpec, capacity_gb: float, *, coherent: bool,
                       copy_sw_overhead: float = 0.6 * US,
                       coherence_overhead: float = 200 * NS) -> MemoryTierSpec:
    """Peer-accelerator memory within a cluster.  Reads are round trips.

    Non-coherent XLink requires explicit software-managed copies
    (paper §5 tier-1 discussion: "sharing data beyond static partitions
    requires explicit software-managed copying"); coherence-centric CXL
    removes the software overhead and accesses at instruction granularity
    but pays directory/snoop time.
    """
    lat = 2.0 * fabric.latency() + (coherence_overhead if coherent else 0.0)
    return MemoryTierSpec(
        name=("Tier1-coherent" if coherent else "XLink-peer(non-coherent)"),
        capacity_bytes=capacity_gb * GB,
        access_latency=lat,
        bandwidth=fabric.bandwidth(),
        sw_overhead=0.0 if coherent else copy_sw_overhead,
    )


def tier2_pool_tier(fabric: FabricSpec, capacity_gb: float = 4096.0) -> MemoryTierSpec:
    """Capacity-oriented tier-2 pool on dedicated memory nodes (§5)."""
    return MemoryTierSpec("Tier2-pool", capacity_gb * GB,
                          2.0 * fabric.latency() + 150 * NS,  # media+controller
                          fabric.bandwidth())


def rdma_storage_tier(fabric: FabricSpec, capacity_gb: float = 1 << 20) -> MemoryTierSpec:
    """Baseline spill target beyond cluster memory: RDMA to remote hosts /
    distributed FS (paper: 'millisecond- to second-level latencies' for
    storage; RDMA-to-host-DRAM is the favourable case we model)."""
    hw_latency = fabric.link.phy_latency + fabric.topology.switching_latency()
    return MemoryTierSpec("RDMA-remote", capacity_gb * GB,
                          2.0 * hw_latency, fabric.bandwidth(),
                          sw_overhead=fabric.link.sw_overhead)


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
