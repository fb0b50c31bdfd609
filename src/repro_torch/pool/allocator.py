"""Topology-aware composable allocation over an ``Inventory``.

Two policies realize the paper's §6 comparison at the *resource* level:

``scalepool``
    Composable disaggregation: accelerators are allocated at single-accel
    granularity, pod selection minimizes CXL hop count (single pod →
    shared leaf switch → full fabric), and capacity requests are
    reserved on tier-2 memory nodes independently of compute.  Tier-2
    *bandwidth* is a second schedulable resource, admitted against the
    routed estate graph (``repro_torch.fabric.Topology``): a reservation
    claims its bytes/s on every link of the pod -> memory-node route,
    so concurrent offload-heavy jobs are refused not just when a node
    is saturated but when a *shared* link (the spine -> capacity-switch
    trunk) is.  A slice of the tier-2 byte reservation may be
    earmarked as a KV grant (``kv_bytes``) — the quantity a serving
    lease turns into a ``KVBudget`` for the ``repro_torch.serve`` engine.

``baseline``
    RDMA-era static partitioning: jobs receive *whole pods* (the unit of
    the fast interconnect domain), and — with no disaggregated memory
    pool — capacity beyond the job's own HBM must be scavenged from the
    HBM of idle accelerators inside its partition, stranding their
    compute.  This is the paper's "sharing data beyond static partitions"
    problem made quantitative.

Free accelerators are tracked per pod in a heap-backed free-list
(O(log n) take/put), so 10^5-job schedules stay tractable — see
``benchmarks/pool_scale.py`` for the guard.

The allocator is the bookkeeping core; admission/timing lives in
``repro_torch.pool.scheduler``.
"""

from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.pool.inventory import Inventory

GB = 1e9


class FreeList:
    """Free accelerator ids of one pod: a min-heap plus a membership set.

    ``take(k)`` pops the k smallest free ids in O(k log n); ``put``
    returns ids in O(log n) each — replacing the O(n) ``list.remove``
    scans that made 10^5-job traces quadratic.
    """

    __slots__ = ("_heap", "_live")

    def __init__(self, ids):
        self._heap = list(ids)
        heapq.heapify(self._heap)
        self._live = set(self._heap)

    def __len__(self) -> int:
        return len(self._live)

    def take(self, k: int) -> Tuple[int, ...]:
        # invariant: _heap and _live hold exactly the same ids (take pops
        # both; put raises on double-free before pushing), so every popped
        # id is live — no lazy-deletion sweep is needed.
        if k > len(self._live):
            raise AssertionError("caller must check capacity before take()")
        out: List[int] = []
        for _ in range(k):
            i = heapq.heappop(self._heap)
            self._live.discard(i)
            out.append(i)
        return tuple(out)

    def put(self, ids) -> None:
        for i in ids:
            if i in self._live:
                raise AssertionError(f"double free of accel {i}")
            self._live.add(i)
            heapq.heappush(self._heap, i)

    def ids(self) -> List[int]:
        return sorted(self._live)

    def clone(self) -> "FreeList":
        fl = FreeList.__new__(FreeList)
        fl._heap = list(self._heap)
        fl._live = set(self._live)
        return fl


@dataclass(frozen=True)
class JobRequest:
    """What a job asks the pool for."""

    name: str
    n_accels: int
    tier2_bytes: float = 0.0      # capacity-tier reservation (offload state)
    kv_bytes: float = 0.0         # slice of tier2_bytes granted to KV paging
    tier2_bw: float = 0.0         # capacity-fabric bandwidth, bytes/s
    # serving tenants sharing this job's kv_bytes as ONE pool: the grant
    # stays a single reservation (no per-tenant carve-up at the
    # allocator), and ``repro_torch.serve.PoolArbiter`` divides the hot pages
    # max-min fairly at runtime while ``lease.kv_share`` hands each
    # tenant its demand-weighted slice of the cold-store bytes.
    tenants: Tuple[str, ...] = ()
    # disaggregated serving: the tier this member of a two-tier gang
    # plays (e.g. "prefill" / "decode").  Pure metadata at the
    # allocator; disaggregated serving binds roles to engine modes.
    role: str = ""
    # live jobs this job will exchange KV handoffs with: under
    # ``policy="contention"`` the placement ALSO scores (and registers)
    # the gateway->peer-gateway handoff route, so the prefill->decode
    # page stream gets a low-overlap path and later jobs avoid it
    peers: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.n_accels <= 0:
            raise ValueError(f"{self.name}: n_accels must be positive")
        if self.tier2_bytes < 0:
            raise ValueError(f"{self.name}: negative tier2_bytes")
        if self.tier2_bw < 0:
            raise ValueError(f"{self.name}: negative tier2_bw")
        if not 0 <= self.kv_bytes <= self.tier2_bytes + 1e-6:
            raise ValueError(
                f"{self.name}: kv_bytes must lie within the tier-2 "
                f"reservation ({self.kv_bytes} vs {self.tier2_bytes})")
        object.__setattr__(self, "tenants",
                           tuple(str(t) for t in self.tenants))
        object.__setattr__(self, "peers",
                           tuple(str(p) for p in self.peers))
        if len(set(self.tenants)) != len(self.tenants):
            raise ValueError(f"{self.name}: duplicate tenant names "
                             f"{self.tenants}")
        if self.tenants and self.kv_bytes <= 0:
            raise ValueError(
                f"{self.name}: a multi-tenant lease shares a KV grant — "
                f"request kv_bytes > 0 for tenants {self.tenants}")


@dataclass(frozen=True)
class Allocation:
    """A granted, disjoint slice of the estate."""

    job: str
    accels: Dict[int, Tuple[int, ...]]   # pod id -> local accel ids
    tier2: Dict[int, float]              # memory-node id -> reserved bytes
    n_requested: int                     # accels the job will actually use
    whole_pods: bool                     # baseline partition granularity
    # capacity the job *asked* for: equals the tier-2 reservation under
    # scalepool; under baseline it is backed by scavenged idle-accel HBM
    # (tier2 stays empty) but the demand is still real.
    tier2_requested: float = 0.0
    # KV slice of the capacity grant (drives serving KVBudgets)
    kv_bytes: float = 0.0
    # capacity-fabric bandwidth: node id -> reserved bytes/s (scalepool);
    # under baseline the demand is recorded but rides the IB fabric.
    tier2_bw: Dict[int, float] = field(default_factory=dict)
    tier2_bw_requested: float = 0.0
    # serving tenants that share this allocation's kv_bytes as one pool
    tenants: Tuple[str, ...] = ()
    # gang role this member plays (disaggregated prefill/decode tiers)
    role: str = ""

    @property
    def n_granted(self) -> int:
        return sum(len(v) for v in self.accels.values())

    @property
    def n_stranded(self) -> int:
        """Accelerators held by the partition but idle (baseline HBM
        scavenging / whole-pod rounding)."""
        return self.n_granted - self.n_requested

    @property
    def pod_ids(self) -> Tuple[int, ...]:
        return tuple(sorted(self.accels))

    @property
    def n_pods(self) -> int:
        return len(self.accels)

    @property
    def tier2_bytes(self) -> float:
        return sum(self.tier2.values())

    @property
    def tier2_bw_total(self) -> float:
        return sum(self.tier2_bw.values())


@dataclass
class PoolMetrics:
    """Instantaneous pool health, the quantities Fig. 8 sweeps."""

    accels_total: int
    accels_granted: int        # held by any allocation
    accels_busy: int           # actually computing (requested)
    tier2_total: float
    tier2_reserved: float
    tier2_bw_total: float      # capacity-fabric bandwidth, bytes/s
    tier2_bw_reserved: float
    tier2_kv_reserved: float   # KV slice of the byte reservations
    fragmentation: float       # 1 - largest free block / min(free, pod size)
    n_jobs: int

    @property
    def utilization(self) -> float:
        return self.accels_busy / self.accels_total if self.accels_total else 0.0

    @property
    def granted_frac(self) -> float:
        return self.accels_granted / self.accels_total if self.accels_total else 0.0

    @property
    def stranded_frac(self) -> float:
        return (self.accels_granted - self.accels_busy) / self.accels_total \
            if self.accels_total else 0.0

    @property
    def tier2_bw_frac(self) -> float:
        return (self.tier2_bw_reserved / self.tier2_bw_total
                if self.tier2_bw_total else 0.0)


class AllocationError(RuntimeError):
    pass


class Allocator:
    """Mutable allocation state over an immutable ``Inventory``."""

    def __init__(self, inventory: Inventory, policy: Optional[str] = None):
        self.inv = inventory
        self.policy = policy or inventory.interconnect
        if self.policy not in ("scalepool", "baseline", "contention"):
            raise ValueError(f"unknown policy {self.policy!r}")
        # free local accel ids per pod, heap-backed (smallest id first for
        # determinism — the same order the old sorted-list scans produced)
        self._free: Dict[int, FreeList] = {
            p.id: FreeList(p.accel_ids()) for p in inventory.pods}
        self._free_t2: Dict[int, float] = {
            m.id: m.capacity for m in inventory.memory_nodes}
        self._free_t2bw: Dict[int, float] = {
            m.id: m.bandwidth for m in inventory.memory_nodes}
        # tier-2 bandwidth admission happens against the routed estate
        # graph, not just per-node scalars: a reservation claims its
        # bytes/s on EVERY link of the pod -> memory-node route, so the
        # shared trunk (spine -> capacity switch) genuinely caps the
        # aggregate even when individual nodes still have headroom
        self.topo = (inventory.topology()
                     if self.policy in ("scalepool", "contention")
                     and inventory.tier2_fabric is not None
                     and inventory.memory_nodes else None)
        self._link_free: Dict[str, float] = (
            {name: l.capacity for name, l in self.topo.links.items()}
            if self.topo is not None else {})
        self._job_links: Dict[str, List[Tuple[str, float]]] = {}
        # predicted collective/offload route links per live job (link
        # names on the estate graph) — what ``policy="contention"``
        # scores candidate placements against
        self._job_route_links: Dict[str, Tuple[str, ...]] = {}
        self.live: Dict[str, Allocation] = {}

    # ---- queries ---------------------------------------------------------
    def free_accels(self, pod_id: Optional[int] = None) -> int:
        if pod_id is not None:
            return len(self._free[pod_id])
        return sum(len(v) for v in self._free.values())

    def free_tier2(self) -> float:
        return sum(self._free_t2.values())

    def free_tier2_bw(self) -> float:
        return sum(self._free_t2bw.values())

    def free_link_bw(self, link_name: str) -> float:
        """Unreserved bytes/s on one link of the routed estate graph."""
        if self.topo is None:
            raise ValueError(
                "routed link admission is inactive for this allocator "
                "(baseline policy, or an inventory without a tier-2 "
                "fabric / memory nodes)")
        return self._link_free[link_name]

    def fully_free_pods(self) -> List[int]:
        return [p.id for p in self.inv.pods
                if len(self._free[p.id]) == p.n_accels]

    # ---- allocation ------------------------------------------------------
    def allocate(self, req: JobRequest) -> Optional[Allocation]:
        """Grant ``req`` or return None (leaving state untouched)."""
        if req.name in self.live:
            raise AllocationError(f"job {req.name!r} already holds an allocation")
        if self.policy == "baseline":
            alloc = self._allocate_baseline(req)
        else:
            alloc = self._allocate_scalepool(req)
        if alloc is not None:
            self.live[alloc.job] = alloc
        return alloc

    def allocate_gang(self, reqs) -> Optional[List[Allocation]]:
        """Two-tier (or N-tier) gang placement: grant every member of
        ``reqs`` in order or none of them (snapshot/rollback).  Each
        member after the first is wired as a handoff peer of all the
        earlier members, so under ``policy="contention"`` the later
        tiers' placement scores the prefill->decode handoff route
        against live traffic — and registers it, keeping later jobs
        off the page stream's links."""
        names = [r.name for r in reqs]
        if len(set(names)) != len(names):
            raise AllocationError(f"duplicate gang member names {names}")
        snap = self.snapshot()
        out: List[Allocation] = []
        for i, req in enumerate(reqs):
            wired = dataclasses.replace(
                req, peers=tuple(dict.fromkeys(req.peers + tuple(names[:i]))))
            alloc = self.allocate(wired)
            if alloc is None:
                self.restore(snap)
                return None
            out.append(alloc)
        return out

    def handoff_route(self, a: Allocation, b: Allocation):
        """The estate route the ``a -> b`` KV handoff stream rides
        (gateway pod to gateway pod), or None when the tiers share a
        gateway pod (the degenerate zero-cost handoff) or the
        allocator has no routed estate graph."""
        if self.topo is None:
            return None
        gw_a, gw_b = min(a.pod_ids), min(b.pod_ids)
        if gw_a == gw_b:
            return None
        return self.topo.route(f"pod:{gw_a}", f"pod:{gw_b}")

    def release(self, job: str) -> None:
        alloc = self.live.pop(job, None)
        if alloc is None:
            raise AllocationError(f"job {job!r} holds no allocation")
        for pod_id, ids in alloc.accels.items():
            self._free[pod_id].put(ids)
        for node_id, nbytes in alloc.tier2.items():
            self._free_t2[node_id] += nbytes
        for node_id, bw in alloc.tier2_bw.items():
            self._free_t2bw[node_id] += bw
        for link_name, bw in self._job_links.pop(job, ()):
            self._link_free[link_name] += bw
        self._job_route_links.pop(job, None)

    # ---- transactional snapshot (for preemption / resize trials) ---------
    def snapshot(self):
        """Opaque copy of the allocation state; pair with ``restore`` to
        roll back a failed multi-step operation."""
        return ({k: v.clone() for k, v in self._free.items()},
                dict(self._free_t2), dict(self._free_t2bw), dict(self.live),
                dict(self._link_free),
                {k: list(v) for k, v in self._job_links.items()},
                dict(self._job_route_links))

    def restore(self, snap) -> None:
        self._free = {k: v.clone() for k, v in snap[0].items()}
        self._free_t2 = dict(snap[1])
        self._free_t2bw = dict(snap[2])
        self.live = dict(snap[3])
        self._link_free = dict(snap[4])
        self._job_links = {k: list(v) for k, v in snap[5].items()}
        self._job_route_links = dict(snap[6])

    # ---- scalepool: composable, hop-minimizing ---------------------------
    def _allocate_scalepool(self, req: JobRequest) -> Optional[Allocation]:
        for peer in req.peers:
            if peer not in self.live:
                raise AllocationError(
                    f"{req.name}: handoff peer {peer!r} holds no live "
                    f"allocation — allocate gang members in order "
                    f"(allocate_gang wires peers automatically)")
        peer_pods = tuple(sorted(min(self.live[p].pod_ids)
                                 for p in req.peers))
        tier2 = self._reserve_pool(self._free_t2, req.tier2_bytes)
        if tier2 is None:
            return None
        tier2_bw = self._reserve_pool(self._free_t2bw, req.tier2_bw)
        if tier2_bw is None:
            return None
        mem_ids = tuple(sorted(set(tier2) | set(tier2_bw)))
        if self.policy == "contention":
            pods = self._pick_pods_contention(req.n_accels, mem_ids,
                                              peer_pods)
        else:
            pods = self._pick_pods_min_hops(req.n_accels)
        if pods is None:
            return None
        link_plan = self._plan_link_bw(min(pods), tier2_bw)
        if link_plan is None:
            return None         # a shared link (e.g. the trunk) is full
        # commit: pop the smallest free ids from the chosen pods
        accels: Dict[int, Tuple[int, ...]] = {}
        remaining = req.n_accels
        for pod_id in pods:
            take = min(remaining, len(self._free[pod_id]))
            accels[pod_id] = self._free[pod_id].take(take)
            remaining -= take
        assert remaining == 0
        for node_id, nbytes in tier2.items():
            self._free_t2[node_id] -= nbytes
        for node_id, bw in tier2_bw.items():
            self._free_t2bw[node_id] -= bw
        for link_name, bw in link_plan:
            self._link_free[link_name] -= bw
        if link_plan:
            self._job_links[req.name] = link_plan
        if self.topo is not None:
            self._job_route_links[req.name] = \
                self._route_link_names(pods, mem_ids, peer_pods)
        return Allocation(req.name, accels, tier2, req.n_accels,
                          whole_pods=False, tier2_requested=req.tier2_bytes,
                          kv_bytes=req.kv_bytes, tier2_bw=tier2_bw,
                          tier2_bw_requested=req.tier2_bw,
                          tenants=req.tenants, role=req.role)

    def _plan_link_bw(self, gateway_pod: int, tier2_bw: Dict[int, float]
                      ) -> Optional[List[Tuple[str, float]]]:
        """Admission-check a per-node bandwidth split against the routed
        estate graph: each node's bytes/s must fit on EVERY link of the
        ``pod:<gateway> -> mem:<node>`` route (the job's offload traffic
        egresses its primary pod — a first-order gateway model; links
        shared between routes, the spine->t2sw trunk above all, see the
        aggregate).  Returns the per-link reservation list, or None if
        any link lacks headroom.  Plan-only: nothing is mutated."""
        if not tier2_bw or self.topo is None:
            return []
        claim: Dict[str, float] = {}
        for node_id, bw in sorted(tier2_bw.items()):
            route = self.topo.route(f"pod:{gateway_pod}", f"mem:{node_id}")
            for link in route.links:
                claim[link.name] = claim.get(link.name, 0.0) + bw
        for name, bw in claim.items():
            if bw > self._link_free[name] + 1e-6:
                return None
        return sorted(claim.items())

    def _pick_pods_min_hops(self, n: int) -> Optional[List[int]]:
        """Pod set minimizing (span hops, pod count): single pod best-fit,
        then one leaf-switch group, then greedy across the fabric."""
        free = {pid: len(v) for pid, v in self._free.items() if len(v)}
        if sum(free.values()) < n:
            return None
        # 1. tightest single pod that fits (best-fit limits fragmentation)
        fitting = [pid for pid, f in free.items() if f >= n]
        if fitting:
            return [min(fitting, key=lambda pid: (free[pid], pid))]
        # 2. one leaf group (1 CXL hop), fewest pods: fill biggest first
        by_leaf: Dict[int, List[int]] = {}
        for pid in free:
            by_leaf.setdefault(self.inv.leaf_of(pid), []).append(pid)
        for leaf in sorted(by_leaf):
            group = by_leaf[leaf]
            if sum(free[p] for p in group) >= n:
                return self._greedy_fill(group, free, n)
        # 3. whole fabric
        return self._greedy_fill(list(free), free, n)

    # ---- contention: hop-minimizing, overlap-avoiding --------------------
    def _route_link_names(self, pods: List[int],
                          mem_ids: Tuple[int, ...],
                          peer_pods: Tuple[int, ...] = ()
                          ) -> Tuple[str, ...]:
        """Predicted estate links a placement's collective + offload
        traffic will occupy: gateway (lowest pod) to every other pod of
        the gang, gateway to every reserved tier-2 node — the same
        routes colocation's ``job_routes`` pins at run time, widened to
        the whole gang — and, for a gang member with handoff peers,
        gateway to every peer gateway (the prefill->decode KV stream's
        route, scored and registered like any other traffic)."""
        if self.topo is None:
            return ()
        gw = min(pods)
        names = set()
        for pid in pods:
            if pid == gw:
                continue
            for link in self.topo.route(f"pod:{gw}", f"pod:{pid}").links:
                names.add(link.name)
        for node_id in mem_ids:
            for link in self.topo.route(f"pod:{gw}",
                                        f"mem:{node_id}").links:
                names.add(link.name)
        for peer_gw in peer_pods:
            if peer_gw == gw:
                continue            # colocated peer: degenerate handoff
            for link in self.topo.route(f"pod:{gw}",
                                        f"pod:{peer_gw}").links:
                names.add(link.name)
        return tuple(sorted(names))

    def _pick_pods_contention(self, n: int, mem_ids: Tuple[int, ...],
                              peer_pods: Tuple[int, ...] = ()
                              ) -> Optional[List[int]]:
        """Hop-minimizing placement that breaks ties by predicted link
        overlap with already-placed jobs' routes: same candidate tiers
        as ``_pick_pods_min_hops`` (single pod, one leaf group, whole
        fabric — hops stay the primary key), but within a tier the
        candidate sharing the fewest links with live jobs wins.  With
        no live jobs every overlap is zero and the choice reduces
        exactly to the min-hops pick.  ``peer_pods`` (handoff peers'
        gateway pods) widen the scored route set with the KV-handoff
        legs, so a decode tier lands where its page stream from the
        prefill tier crosses the fewest already-busy links."""
        free = {pid: len(v) for pid, v in self._free.items() if len(v)}
        if sum(free.values()) < n:
            return None
        busy: set = set()
        for links in self._job_route_links.values():
            busy.update(links)

        def overlap(pods: List[int]) -> int:
            return sum(1 for name in self._route_link_names(pods, mem_ids,
                                                            peer_pods)
                       if name in busy)

        # 1. single pod: (overlap, tightest fit, id) — legacy order when
        #    nothing is placed yet
        fitting = [pid for pid, f in free.items() if f >= n]
        if fitting:
            return [min(fitting,
                        key=lambda pid: (overlap([pid]), free[pid], pid))]
        # 2. one leaf group: legacy takes the first leaf with capacity;
        #    here the least-overlapping one (leaf id breaks ties)
        by_leaf: Dict[int, List[int]] = {}
        for pid in free:
            by_leaf.setdefault(self.inv.leaf_of(pid), []).append(pid)
        best = None
        for leaf in sorted(by_leaf):
            group = by_leaf[leaf]
            if sum(free[p] for p in group) < n:
                continue
            pods = self._greedy_fill(group, free, n)
            key = (overlap(pods), leaf)
            if best is None or key < best[0]:
                best = (key, pods)
        if best is not None:
            return best[1]
        # 3. whole fabric (one candidate — nothing to score)
        return self._greedy_fill(list(free), free, n)

    @staticmethod
    def _greedy_fill(pods: List[int], free: Dict[int, int], n: int) -> List[int]:
        chosen, got = [], 0
        for pid in sorted(pods, key=lambda p: (-free[p], p)):
            chosen.append(pid)
            got += free[pid]
            if got >= n:
                return chosen
        raise AssertionError("caller guaranteed capacity")

    @staticmethod
    def _reserve_pool(free: Dict[int, float], amount: float) \
            -> Optional[Dict[int, float]]:
        """Plan a reservation of ``amount`` over a per-node scalar resource
        (bytes or bytes/s): fewest nodes, drain the fullest first."""
        if amount <= 0:
            return {}
        if sum(free.values()) < amount:
            return None
        out: Dict[int, float] = {}
        remaining = amount
        for node_id in sorted(free, key=lambda i: (-free[i], i)):
            if remaining <= 0:
                break
            take = min(remaining, free[node_id])
            if take > 0:
                out[node_id] = take
                remaining -= take
        assert remaining <= 1e-6
        return out

    # ---- baseline: static whole-pod partitions ---------------------------
    def _allocate_baseline(self, req: JobRequest) -> Optional[Allocation]:
        pod_size = self.inv.pod_size
        hbm = self.inv.pods[0].hbm_per_accel
        import math
        pods_needed = math.ceil(req.n_accels / pod_size)
        # no memory pool: capacity beyond the job's accelerators comes from
        # idle accels' HBM inside the partition -> possibly more pods.
        if req.tier2_bytes > 0:
            while (pods_needed * pod_size - req.n_accels) * hbm < req.tier2_bytes:
                pods_needed += 1
                if pods_needed > self.inv.n_pods:
                    return None
        free_pods = self.fully_free_pods()
        if len(free_pods) < pods_needed:
            return None
        chosen = sorted(free_pods)[:pods_needed]   # first-fit, contiguous ids
        accels = {pid: self._free[pid].take(len(self._free[pid]))
                  for pid in chosen}
        return Allocation(req.name, accels, {}, req.n_accels, whole_pods=True,
                          tier2_requested=req.tier2_bytes,
                          kv_bytes=req.kv_bytes,
                          tier2_bw_requested=req.tier2_bw,
                          tenants=req.tenants)

    # ---- metrics & invariants --------------------------------------------
    def metrics(self) -> PoolMetrics:
        total = self.inv.total_accels
        granted = sum(a.n_granted for a in self.live.values())
        busy = sum(a.n_requested for a in self.live.values())
        free = self.free_accels()
        largest = max((len(v) for v in self._free.values()), default=0)
        # external fragmentation relative to the best a pod-local (XLink)
        # job could hope for: an empty estate scores 0, free capacity
        # shattered across partially-used pods scores toward 1.
        best_block = min(free, self.inv.pod_size)
        frag = 1.0 - largest / best_block if best_block > 0 else 0.0
        return PoolMetrics(
            accels_total=total, accels_granted=granted, accels_busy=busy,
            tier2_total=self.inv.total_tier2,
            tier2_reserved=self.inv.total_tier2 - self.free_tier2(),
            tier2_bw_total=self.inv.total_tier2_bw,
            tier2_bw_reserved=self.inv.total_tier2_bw - self.free_tier2_bw(),
            tier2_kv_reserved=sum(a.kv_bytes for a in self.live.values()),
            fragmentation=frag, n_jobs=len(self.live))

    def check_conservation(self) -> None:
        """Invariant: free + granted == inventory, no accel held twice."""
        seen = set()
        for alloc in self.live.values():
            for pod_id, ids in alloc.accels.items():
                for i in ids:
                    key = (pod_id, i)
                    if key in seen:
                        raise AssertionError(f"double allocation of {key}")
                    seen.add(key)
        for p in self.inv.pods:
            held = {(p.id, i) for i in p.accel_ids()}
            free = {(p.id, i) for i in self._free[p.id].ids()}
            alloced = {k for k in seen if k[0] == p.id}
            if free | alloced != held or free & alloced:
                raise AssertionError(f"pod {p.id}: conservation violated")
        for m in self.inv.memory_nodes:
            reserved = sum(a.tier2.get(m.id, 0.0) for a in self.live.values())
            if abs(reserved + self._free_t2[m.id] - m.capacity) > 1e-3:
                raise AssertionError(f"memory node {m.id}: conservation violated")
            bw = sum(a.tier2_bw.get(m.id, 0.0) for a in self.live.values())
            if abs(bw + self._free_t2bw[m.id] - m.bandwidth) > 1e-3:
                raise AssertionError(
                    f"memory node {m.id}: bandwidth conservation violated")
        if self.topo is not None:
            held: Dict[str, float] = {}
            for job, links in self._job_links.items():
                if job not in self.live:
                    raise AssertionError(
                        f"link reservations for dead job {job!r}")
                for name, bw in links:
                    held[name] = held.get(name, 0.0) + bw
            for name, link in self.topo.links.items():
                reserved = held.get(name, 0.0)
                if abs(reserved + self._link_free[name] - link.capacity) > 1e-3:
                    raise AssertionError(
                        f"link {name}: bandwidth conservation violated")
