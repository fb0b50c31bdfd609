"""Cluster inventory for the ScalePool orchestrator (paper §3-§5).

Describes the *static* composable hardware estate: XLink pods
(accelerator clusters with single-hop switched fabrics), the hierarchical
CXL switching fabric stitching pods together, and the dedicated tier-2
memory nodes hanging off the capacity-oriented CXL fabric.  Everything is
derived from the link/switch/topology models in ``repro_torch.core.fabric`` —
the inventory adds only *identity* (which accelerator, which pod, which
memory node) so an allocator can hand out disjoint subsets.

The inventory is immutable; allocation state lives in
``repro_torch.pool.allocator``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import fabric as fb

GB = fb.GB


@dataclass(frozen=True)
class PodSpec:
    """One XLink accelerator cluster (a GB200-NVL72-class rack, §4)."""

    id: int
    n_accels: int
    hbm_per_accel: float          # bytes
    fabric: fb.FabricSpec         # single-hop XLink fabric inside the pod

    @property
    def hbm_total(self) -> float:
        return self.n_accels * self.hbm_per_accel

    def accel_ids(self) -> range:
        return range(self.n_accels)


@dataclass(frozen=True)
class MemoryNodeSpec:
    """A CPU-less tier-2 memory node on the capacity CXL fabric (§5).

    ``bandwidth`` is the node's sustainable capacity-fabric throughput
    (bytes/s) — a schedulable resource alongside capacity: concurrent
    offload-heavy jobs contend on it and the allocator admission-controls
    reservations (ROADMAP: tier-2 bandwidth, not just bytes).
    """

    id: int
    capacity: float               # bytes
    bandwidth: float = 0.0        # bytes/s sustainable on the CXL.io path


@dataclass(frozen=True)
class Inventory:
    """The composable estate: pods + inter-pod fabric + tier-2 nodes.

    ``interconnect`` selects the inter-pod technology: ``"scalepool"``
    (hierarchical CXL, tier-2 pool reachable) or ``"baseline"``
    (InfiniBand RDMA scale-out, no disaggregated memory pool — capacity
    beyond HBM must be scavenged from idle accelerators' HBM).
    """

    pods: Tuple[PodSpec, ...]
    memory_nodes: Tuple[MemoryNodeSpec, ...]
    inter_fabric: fb.FabricSpec           # pod-to-pod fabric (CXL or IB)
    tier2_fabric: Optional[fb.FabricSpec] # capacity fabric; None = baseline
    interconnect: str = "scalepool"   # scalepool | baseline | contention
    # shared spine -> capacity-switch trunk bandwidth (bytes/s) of the
    # routed estate graph; 0 = full bisection (sum of memory-node
    # bandwidths).  An oversubscribed trunk makes aggregate tier-2
    # bandwidth a *fabric* constraint the allocator admission-controls,
    # not just a per-node one.
    tier2_trunk_bw: float = 0.0

    # ---- sizes -----------------------------------------------------------
    @property
    def n_pods(self) -> int:
        return len(self.pods)

    @property
    def pod_size(self) -> int:
        return self.pods[0].n_accels if self.pods else 0

    @property
    def total_accels(self) -> int:
        return sum(p.n_accels for p in self.pods)

    @property
    def total_hbm(self) -> float:
        return sum(p.hbm_total for p in self.pods)

    @property
    def total_tier2(self) -> float:
        return sum(m.capacity for m in self.memory_nodes)

    @property
    def total_tier2_bw(self) -> float:
        return sum(m.bandwidth for m in self.memory_nodes)

    # ---- topology distance ----------------------------------------------
    @property
    def pods_per_leaf(self) -> int:
        """Pods sharing one leaf switch of the inter-pod fabric.  In a
        folded Clos, half the radix faces down; each pod consumes one
        downlink group."""
        return max(1, self.inter_fabric.topology.switch.radix // 2)

    def pod_hops(self, pod_a: int, pod_b: int) -> int:
        """Inter-pod switch traversals between two pods: 0 within a pod,
        1 through a shared leaf switch, full up-down path otherwise."""
        if pod_a == pod_b:
            return 0
        if pod_a // self.pods_per_leaf == pod_b // self.pods_per_leaf:
            return 1
        return self.inter_fabric.topology.hops()

    def span_hops(self, pod_ids: Iterable[int]) -> int:
        """Worst-case pairwise hop count across a set of pods — the
        quantity a topology-aware allocator minimizes."""
        ids = sorted(set(pod_ids))
        worst = 0
        for i, a in enumerate(ids):
            for b in ids[i + 1:]:
                worst = max(worst, self.pod_hops(a, b))
        return worst

    def leaf_of(self, pod_id: int) -> int:
        return pod_id // self.pods_per_leaf

    def topology(self, *, accels: bool = False):
        """The routed estate graph (``repro_torch.fabric.Topology``): pods,
        CXL leaf/spine switch tiers, the capacity-fabric switch, and
        tier-2 memory nodes — the graph the allocator admission-
        controls ``tier2_bw`` reservations on and serving transports
        route transfers over."""
        from repro_torch.fabric import Topology
        return Topology.from_inventory(self, accels=accels)

    def describe(self) -> str:
        t2 = (f"{self.total_tier2 / GB:.0f}GB tier-2 over "
              f"{len(self.memory_nodes)} nodes" if self.memory_nodes
              else "no tier-2 pool")
        return (f"{self.n_pods} pods x {self.pod_size} accels "
                f"({self.total_accels} total, "
                f"{self.total_hbm / GB:.0f}GB HBM), "
                f"inter={self.inter_fabric.name}, {t2}")


def build_inventory(
    *,
    n_pods: int = 4,
    pod_size: int = 72,
    hbm_per_accel_gb: float = 192.0,
    n_memory_nodes: int = 8,
    memory_node_gb: float = 4096.0,
    memory_node_gbps: Optional[float] = None,
    tier2_trunk_gbps: Optional[float] = None,
    interconnect: str = "scalepool",
    xlink: fb.LinkSpec = fb.NVLINK5,
) -> Inventory:
    """Construct an estate from the paper's hardware constants.

    Defaults mirror ``core.simulator.Calibration`` (72-accel NVL72-class
    pods, 192GB HBM) and §5's 4TB-class memory nodes.
    """
    pod_fabric = fb.xlink_cluster_fabric(pod_size, xlink)
    pods = tuple(PodSpec(i, pod_size, hbm_per_accel_gb * GB, pod_fabric)
                 for i in range(n_pods))
    n_endpoints = n_pods * pod_size
    if interconnect in ("scalepool", "contention"):
        # "contention" is the scalepool estate with overlap-aware
        # placement — the hardware is identical, only WHERE a gang
        # lands differs (repro_torch.pool.allocator picks the policy up from
        # Inventory.interconnect)
        inter = fb.cxl_fabric(n_endpoints, link=fb.CXL_COHERENCE)
        tier2 = fb.tier2_memory_fabric(max(8, n_memory_nodes))
        # per-node sustainable bandwidth defaults to the capacity fabric's
        # effective large-message rate (CXL.io bulk path, §5)
        node_bw = (memory_node_gbps * GB if memory_node_gbps is not None
                   else tier2.bandwidth() * GB)
        nodes = tuple(MemoryNodeSpec(i, memory_node_gb * GB, node_bw)
                      for i in range(n_memory_nodes))
    elif interconnect == "baseline":
        inter = fb.infiniband_fabric(n_endpoints)
        tier2 = None
        nodes = ()   # RDMA era: no composable memory pool
    else:
        raise ValueError(f"unknown interconnect {interconnect!r}")
    return Inventory(pods=pods, memory_nodes=nodes, inter_fabric=inter,
                     tier2_fabric=tier2, interconnect=interconnect,
                     tier2_trunk_bw=(tier2_trunk_gbps * GB
                                     if tier2_trunk_gbps is not None else 0.0))
