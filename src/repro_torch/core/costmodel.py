"""Collective-communication and transfer cost model over fabrics/routes.

Implements standard alpha-beta collective algorithms (ring / tree /
hierarchical two-level) on top of ``repro_torch.core.fabric`` transfer-time
primitives, plus the hierarchical ScalePool schedule the paper's §4
describes: bulk intra-cluster movement on XLink, inter-cluster phase on
the CXL fabric, with no software stack on the data path.

Every function takes a ``Fabric`` — anything implementing the
``transfer_time(nbytes, contention=...)`` contract.  That is either
the legacy closed-form ``core.fabric.FabricSpec`` OR a routed
``repro_torch.fabric.Route`` from ``Topology.route(src, dst)``, so collective
costs can be priced on the actual hop list between two endpoints of
the estate graph (per-hop latency accumulates; serialization is paid
at the route's bottleneck link) instead of a whole-fabric aggregate.

All functions return seconds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Union

from repro_torch.core.fabric import FabricSpec

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.fabric import Route

# anything pricing transfer_time(nbytes, contention=): a closed-form
# fabric spec or a routed hop list over the estate graph
Fabric = Union[FabricSpec, "Route"]

GB = 1e9


def p2p_time(fabric: Fabric, nbytes: int) -> float:
    """One point-to-point message (pipeline-parallel activations, KV ship)."""
    return fabric.transfer_time(nbytes)


def ring_allreduce_time(fabric: Fabric, nbytes: int, n: int) -> float:
    """Ring all-reduce of an ``nbytes`` buffer over ``n`` ranks.

    2*(n-1) steps, each moving nbytes/n per rank.  Latency term pays the
    fabric latency per step (this is what kills RDMA at small buffers —
    each step re-enters the software stack)."""
    if n <= 1 or nbytes <= 0:
        return 0.0
    chunk = max(1, math.ceil(nbytes / n))
    steps = 2 * (n - 1)
    return steps * fabric.transfer_time(chunk)


def reduce_scatter_time(fabric: Fabric, nbytes: int, n: int) -> float:
    if n <= 1 or nbytes <= 0:
        return 0.0
    chunk = max(1, math.ceil(nbytes / n))
    return (n - 1) * fabric.transfer_time(chunk)


def all_gather_time(fabric: Fabric, nbytes: int, n: int) -> float:
    """All-gather where each rank ends with ``nbytes`` total (ring)."""
    if n <= 1 or nbytes <= 0:
        return 0.0
    chunk = max(1, math.ceil(nbytes / n))
    return (n - 1) * fabric.transfer_time(chunk)


def tree_allreduce_time(fabric: Fabric, nbytes: int, n: int) -> float:
    """Binary-tree reduce+broadcast — latency-optimal for small buffers."""
    if n <= 1 or nbytes <= 0:
        return 0.0
    depth = math.ceil(math.log2(n))
    return 2 * depth * fabric.transfer_time(nbytes)


def allreduce_time(fabric: Fabric, nbytes: int, n: int) -> float:
    """Best of ring / tree (what a tuned collective library would pick)."""
    if n <= 1 or nbytes <= 0:
        return 0.0
    return min(ring_allreduce_time(fabric, nbytes, n),
               tree_allreduce_time(fabric, nbytes, n))


def all_to_all_time(fabric: Fabric, nbytes_per_rank: int, n: int) -> float:
    """All-to-all (MoE dispatch): each rank sends nbytes_per_rank to each
    other rank; serialized through its single injection port."""
    if n <= 1 or nbytes_per_rank <= 0:
        return 0.0
    return (n - 1) * fabric.transfer_time(nbytes_per_rank)


@dataclass(frozen=True)
class HierarchicalDomains:
    """Two-level communication domain: ``intra`` fabric groups of size
    ``intra_size`` stitched by an ``inter`` fabric across ``n_groups``."""

    intra: Fabric
    inter: Fabric
    intra_size: int
    n_groups: int

    @property
    def world(self) -> int:
        return self.intra_size * self.n_groups


def hierarchical_allreduce_time(dom: HierarchicalDomains, nbytes: int) -> float:
    """ScalePool schedule (also the classic NCCL 2-level algorithm):

      1. reduce-scatter inside each XLink cluster        (fast fabric)
      2. all-reduce of the 1/intra_size shard across clusters (CXL/IB)
      3. all-gather inside each cluster                  (fast fabric)

    The inter-cluster fabric only ever carries nbytes/intra_size per
    endpoint — this is the structural reason ScalePool's comm win is
    larger than the raw link-speed ratio."""
    if dom.world <= 1 or nbytes <= 0:
        return 0.0
    t = reduce_scatter_time(dom.intra, nbytes, dom.intra_size)
    shard = max(1, math.ceil(nbytes / max(1, dom.intra_size)))
    t += allreduce_time(dom.inter, shard, dom.n_groups)
    t += all_gather_time(dom.intra, nbytes, dom.intra_size)
    return t


def flat_allreduce_time(dom: HierarchicalDomains, nbytes: int) -> float:
    """Baseline: one flat ring spanning all ranks; every step bounded by the
    slowest fabric it crosses (inter-cluster links dominate)."""
    if dom.world <= 1 or nbytes <= 0:
        return 0.0
    chunk = max(1, math.ceil(nbytes / dom.world))
    # 2*(world-1) ring steps; a fraction (n_groups/world) of the links on
    # the ring are inter-cluster, but ring progress is lock-step: each step
    # completes at the pace of the slowest link in the ring.
    steps = 2 * (dom.world - 1)
    return steps * dom.inter.transfer_time(chunk)


def broadcast_time(fabric: Fabric, nbytes: int, n: int) -> float:
    if n <= 1 or nbytes <= 0:
        return 0.0
    return math.ceil(math.log2(n)) * fabric.transfer_time(nbytes)


def offload_roundtrip_time(tier_bw_gbps: float, tier_latency: float,
                           nbytes: int, sw_overhead: float = 0.0) -> float:
    """Write-then-read of an offloaded buffer (optimizer state shuttle)."""
    if nbytes <= 0:
        return 0.0
    one_way = sw_overhead + tier_latency + nbytes / (tier_bw_gbps * GB)
    return 2.0 * one_way


# ---------------------------------------------------------------------------
# routed in-flight pricing (repro_torch.colo): base + contention stretch
# ---------------------------------------------------------------------------

def phase_volume(base_s: float, route: "Route") -> float:
    """Payload bytes whose *solo* transfer on ``route`` lasts exactly
    ``base_s`` seconds — the volume to register on a ``Transport`` so a
    closed-form collective phase occupies its route for its legacy
    duration.  Zero when the phase is shorter than the route latency
    (nothing meaningful to serialize)."""
    if base_s <= route.latency():
        return 0.0
    return (base_s - route.latency()) * route.bottleneck_bw


def routed_phase_time(transport, route: "Route", base_s: float,
                      t: float, *, label: Optional[str] = None) -> float:
    """Price one collective phase of legacy closed-form duration
    ``base_s`` as an in-flight transfer beginning at modeled time ``t``
    on a shared ``fabric.Transport``: the phase max-min shares links
    with everything else in flight (serving spill/fetch traffic,
    other jobs' collectives) and comes back stretched accordingly.

    Bit-exactness contract (the fig6 regression pins this): the return
    value is ``base_s`` plus the *contention stretch only*, where the
    stretch compares the transport's duration against the identical
    float expression the transport's solo fast path evaluates
    (``route.latency() + v / route.bottleneck_bw``).  Re-deriving the
    solo time from ``base_s`` instead would leak one float rounding
    per phase (``(x * bw) / bw != x``) into every uncontended step.
    """
    v = phase_volume(base_s, route)
    if v <= 0.0:
        return base_s
    dur = transport.transfer_s(route, v, t, label=label)
    solo = route.latency() + v / route.bottleneck_bw
    return base_s + max(0.0, dur - solo)
