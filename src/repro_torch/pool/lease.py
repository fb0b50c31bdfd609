"""Allocation leases: the bridge from the orchestrator to the runtime
(port of ``repro.pool.lease``).

A ``Lease`` is a granted allocation plus everything the serving stack
needs to *use* it: the devices it runs on, a logical mesh shape that
mirrors the lease's pod topology, and a ``TieringPolicy`` that routes
state to the capacity tier exactly when the lease carries a tier-2
reservation.  ``materialize`` returns a ``LeaseBinding`` (devices, mesh
shape and axes, policy) where the reference builds a ``jax`` mesh: the
port runs on one card, so the shape is bookkeeping the lease==local
contract keeps, not a device layout.  Elastic grow/shrink produces a
re-sharding plan via ``repro_torch.ckpt.elastic.resize_plan``.

``ResourcePool`` is the user-facing facade: build one over an inventory,
take leases, hand them to ``Engine.from_lease`` /
``runtime.serve.make_lease_session``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis import tiebreak
from repro_torch.ckpt.elastic import resize_plan
from repro_torch.core.tiering import KVBudget, TieringPolicy
from repro_torch.device import resolve_device
from repro_torch.pool.allocator import (Allocation, AllocationError, Allocator,
                                  JobRequest)
from repro_torch.pool.inventory import Inventory, build_inventory

GB = 1e9


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


@dataclass(frozen=True)
class LeaseBinding:
    """What ``Lease.materialize`` binds: the devices the runtime runs on
    (the first is the engine's), the logical mesh ``shape`` / ``axes``
    of ``Lease.mesh_shape`` over them, and the lease's tiering policy."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    policy: TieringPolicy

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.axes


@dataclass(frozen=True)
class Lease:
    """A live claim on pool resources, materializable as devices + mesh
    shape + policy."""

    allocation: Allocation
    model_parallel: int = 1

    @property
    def job(self) -> str:
        return self.allocation.job

    @property
    def n_accels(self) -> int:
        return self.allocation.n_requested

    @property
    def tier2_bytes(self) -> float:
        return self.allocation.tier2_bytes

    @property
    def kv_bytes(self) -> float:
        """The KV slice of the tier-2 grant (drives serving KV budgets)."""
        return self.allocation.kv_bytes

    @property
    def tier2_bw(self) -> float:
        return self.allocation.tier2_bw_total

    @property
    def spans_pods(self) -> bool:
        return self.allocation.n_pods > 1

    @property
    def tenants(self) -> Tuple[str, ...]:
        """Serving tenants sharing this lease's KV grant as one pool."""
        return self.allocation.tenants

    @property
    def role(self) -> str:
        """Gang role this sub-lease plays (disaggregated serving tiers,
        e.g. ``"prefill"`` / ``"decode"``); empty for a plain lease."""
        return self.allocation.role

    # ---- runtime binding -------------------------------------------------
    def kv_budget(self, *, page_size: int = 64) -> Optional[KVBudget]:
        """The lease's KV grant as an engine-consumable ``KVBudget``:
        tier-2 bytes are the allocator's actual grant; the tier-1 page
        quota is left for the engine to derive from its slot geometry."""
        if self.kv_bytes <= 0:
            return None
        return KVBudget(tier1_pages=None, tier2_bytes=self.kv_bytes,
                        page_size=page_size)

    def kv_shares(self, demands: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
        """Demand-weighted split of the shared cold-store grant: max-min
        water-filling over per-tenant byte demands, mirroring the hot
        page-share logic in ``repro_torch.serve.PoolArbiter._shares``.  A
        tenant demanding no more than the even split is *saturated* —
        it gets exactly its demand and donates the surplus to heavier
        demanders (the elasticity staging-heavy disagg traffic needs);
        bytes left after every demand is met are returned to all
        tenants as an equal headroom bonus, so the shares always sum to
        ``kv_bytes`` and a quiet tenant keeps spill headroom.  With no
        demands (``None`` or all zero) every tenant gets exactly
        ``kv_bytes / N`` — the legacy static split.

        Sharing incentive (pinned by test): a tenant demanding at least
        the even split never receives less than ``kv_bytes / N``."""
        if not self.tenants:
            raise ValueError(
                f"lease {self.job!r} was not taken with tenants= — "
                f"use kv_budget() for single-tenant serving")
        demands = demands or {}
        unknown = sorted(set(demands) - set(self.tenants))
        if unknown:
            raise KeyError(
                f"{unknown[0]!r} is not a tenant of lease {self.job!r} "
                f"(tenants: {self.tenants})")
        shares = {t: 0.0 for t in self.tenants}
        pending = {t: max(0.0, float(demands.get(t, 0.0)))
                   for t in self.tenants}
        remaining = self.kv_bytes
        while pending:
            level = remaining / len(pending)
            # selection is a demand threshold — order() only permutes
            # the scan (racecheck seam); the filtered set is order-free
            sat = [t for t, d in tiebreak.order(sorted(pending.items()))
                   if d <= level]
            if not sat:
                # everyone still pending wants more than the even
                # split: level each, nothing left to donate
                for t in sorted(pending):
                    shares[t] += level
                remaining = 0.0
                break
            for t in sorted(sat):
                shares[t] += pending.pop(t)
                remaining -= shares[t]
        if remaining > 0.0 and self.kv_bytes > 0:
            bonus = remaining / len(self.tenants)
            for t in shares:
                shares[t] += bonus
        return shares

    def kv_share(self, tenant: str, *, page_size: int = 64,
                 demands: Optional[Dict[str, float]] = None) -> KVBudget:
        """One tenant's slice of the shared KV grant.  The cold-store
        *bytes* are split by demand-weighted water-filling over
        ``demands`` (see ``kv_shares``; omitted demands mean the legacy
        equal split — a tenant's spill headroom is its own, so a hog
        cannot exhaust a neighbor's tier-2 budget); the hot tier-1
        *pages* stay one shared pool, divided dynamically by
        ``repro_torch.serve.PoolArbiter`` as a revocable max-min fair
        share."""
        if not self.tenants:
            raise ValueError(
                f"lease {self.job!r} was not taken with tenants= — "
                f"use kv_budget() for single-tenant serving")
        if tenant not in self.tenants:
            raise KeyError(
                f"{tenant!r} is not a tenant of lease {self.job!r} "
                f"(tenants: {self.tenants})")
        if not demands:
            # the exact legacy float: bit-compatible with every
            # existing from_lease construction
            share = self.kv_bytes / len(self.tenants)
        else:
            share = self.kv_shares(demands)[tenant]
        return KVBudget(tier1_pages=None, tier2_bytes=share,
                        page_size=page_size)

    def tiering_policy(self) -> TieringPolicy:
        """Capacity demand → offload policy: a lease with capacity
        backing offloads optimizer state (train) / budgets KV paging
        (serve).  Under the baseline policy that backing is scavenged
        idle-accel HBM (``tier2_requested`` with an empty reservation) —
        the demand still offloads, it just lands in the stranded
        partition."""
        has_t2 = self.allocation.tier2_requested > 0 or self.tier2_bytes > 0
        return TieringPolicy(offload_optimizer=has_t2,
                             kv_budget=self.kv_budget())

    def mesh_shape(self, n_devices: int) -> Tuple[Tuple[int, ...],
                                                  Tuple[str, ...]]:
        """Map the lease's logical topology onto ``n_devices`` local
        devices: the pod axis mirrors the allocation's pod span; model
        parallelism is honored as far as divisibility allows."""
        span = self.allocation.n_pods
        if span > 1 and n_devices % span == 0 and n_devices // span > 1:
            per_pod = n_devices // span
            m = _largest_divisor_leq(per_pod, self.model_parallel)
            return (span, per_pod // m, m), ("pod", "data", "model")
        m = _largest_divisor_leq(n_devices, self.model_parallel)
        return (n_devices // m, m), ("data", "model")

    def materialize(self, devices=None) -> LeaseBinding:
        """Bind this lease to devices: the mesh shape over them and the
        tiering policy.

        ``devices``: optional explicit device list (``["cpu"]`` to run on
        the CPU); the default is every visible card, and without CUDA
        that raises, as every entry point of the port does.
        """
        if devices is not None:
            devs = [resolve_device(d) for d in devices]
        else:
            resolve_device(None)
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        shape, axes = self.mesh_shape(len(devs))
        return LeaseBinding(tuple(devs), shape, axes, self.tiering_policy())


class ResourcePool:
    """Facade: inventory + allocator + lease lifecycle."""

    def __init__(self, inventory: Optional[Inventory] = None,
                 policy: Optional[str] = None, **inventory_kwargs):
        self.inv = inventory or build_inventory(**inventory_kwargs)
        self.alloc = Allocator(self.inv, policy)
        self.leases: Dict[str, Lease] = {}

    def lease(self, name: str, n_accels: int, *, tier2_gb: float = 0.0,
              kv_gb: float = 0.0, tier2_gbps: float = 0.0,
              model_parallel: int = 1,
              tenants: Tuple[str, ...] = ()) -> Lease:
        """Take a lease: ``kv_gb`` earmarks a slice of the tier-2
        reservation as a KV-paging grant (serving engines turn it into a
        ``KVBudget``); ``tier2_gbps`` reserves capacity-fabric bandwidth.
        ``tenants`` names serving tenants that will share the KV grant
        as ONE pool (see ``Lease.kv_share`` / ``serve.PoolArbiter``)."""
        allocation = self.alloc.allocate(
            JobRequest(name, n_accels, tier2_gb * GB, kv_bytes=kv_gb * GB,
                       tier2_bw=tier2_gbps * GB, tenants=tenants))
        if allocation is None:
            m = self.alloc.metrics()
            raise AllocationError(
                f"pool cannot satisfy {name!r}: wanted {n_accels} accels + "
                f"{tier2_gb:.0f}GB tier-2 + {tier2_gbps:.0f}GB/s; free: "
                f"{self.alloc.free_accels()} accels, "
                f"{self.alloc.free_tier2() / GB:.0f}GB, "
                f"{self.alloc.free_tier2_bw() / GB:.0f}GB/s "
                f"(utilization {m.utilization:.0%})")
        lease = Lease(allocation, model_parallel=model_parallel)
        self.leases[name] = lease
        return lease

    def lease_gang(self, name: str, roles: Dict[str, Dict],
                   *, model_parallel: int = 1) -> Dict[str, Lease]:
        """Role-tagged sub-leases off ONE gang grant (the disaggregated
        prefill/decode estate shape): ``roles`` maps a role name to its
        lease kwargs (``n_accels`` required; ``tier2_gb``/``kv_gb``/
        ``tier2_gbps``/``tenants`` optional).  Members are placed
        all-or-nothing in declaration order; each later member's
        placement scores the handoff route back to the earlier tiers
        (``policy="contention"``).  Each sub-lease is a full ``Lease``
        named ``<name>/<role>`` — releasable individually or together
        via ``release_gang``."""
        reqs = []
        for role, kw in roles.items():
            extra = sorted(set(kw) - {"n_accels", "tier2_gb", "kv_gb",
                                      "tier2_gbps", "tenants"})
            if extra:
                raise TypeError(f"{name}/{role}: unknown lease kwargs "
                                f"{extra}")
            reqs.append(JobRequest(
                f"{name}/{role}", kw["n_accels"],
                kw.get("tier2_gb", 0.0) * GB,
                kv_bytes=kw.get("kv_gb", 0.0) * GB,
                tier2_bw=kw.get("tier2_gbps", 0.0) * GB,
                tenants=tuple(kw.get("tenants", ())), role=role))
        allocs = self.alloc.allocate_gang(reqs)
        if allocs is None:
            m = self.alloc.metrics()
            raise AllocationError(
                f"pool cannot satisfy gang {name!r} "
                f"({', '.join(r.name for r in reqs)}); free: "
                f"{self.alloc.free_accels()} accels, "
                f"{self.alloc.free_tier2() / GB:.0f}GB "
                f"(utilization {m.utilization:.0%})")
        out: Dict[str, Lease] = {}
        for alloc in allocs:
            lease = Lease(alloc, model_parallel=model_parallel)
            self.leases[alloc.job] = lease
            out[alloc.role] = lease
        return out

    def release_gang(self, name: str) -> None:
        """Release every sub-lease of gang ``name`` (prefix match on
        ``<name>/``)."""
        members = [job for job in sorted(self.leases)
                   if job.startswith(f"{name}/")]
        if not members:
            raise AllocationError(f"no gang {name!r} sub-leases held")
        for job in members:
            self.release(job)

    def handoff_route(self, a: Lease, b: Lease):
        """The estate route an ``a -> b`` KV handoff stream rides, or
        None when the tiers share a gateway pod (degenerate handoff)."""
        return self.alloc.handoff_route(a.allocation, b.allocation)

    def release(self, lease_or_name) -> None:
        name = (lease_or_name if isinstance(lease_or_name, str)
                else lease_or_name.job)
        self.alloc.release(name)
        del self.leases[name]

    def resize(self, lease_or_name, n_accels: int,
               *, tier2_gb: Optional[float] = None) -> Tuple[Lease, Dict[str, int]]:
        """Elastic grow/shrink: atomically trade the old allocation for a
        new one (old resources count as free during re-placement)."""
        name = (lease_or_name if isinstance(lease_or_name, str)
                else lease_or_name.job)
        old = self.leases[name]
        t2 = old.tier2_bytes if tier2_gb is None else tier2_gb * GB
        # validate the re-sharding plan BEFORE touching allocator state so
        # an impossible decomposition can't leave a half-committed resize
        plan = resize_plan(old.n_accels, n_accels,
                           model_parallel=old.model_parallel)
        snapshot = self.alloc.snapshot()
        self.alloc.release(name)
        allocation = self.alloc.allocate(JobRequest(
            name, n_accels, t2,
            kv_bytes=min(old.allocation.kv_bytes, t2),
            tier2_bw=old.allocation.tier2_bw_requested,
            tenants=old.allocation.tenants))
        if allocation is None:
            self.alloc.restore(snapshot)
            raise AllocationError(
                f"cannot resize {name!r} to {n_accels} accels")
        new_lease = dataclasses.replace(old, allocation=allocation)
        self.leases[name] = new_lease
        return new_lease, plan

    def metrics(self):
        return self.alloc.metrics()


def smoke_pool(policy: str = "scalepool") -> ResourcePool:
    """A small deterministic estate for CPU tests/demos: 4 pods x 8
    accels, two 1TB memory nodes (scalepool/contention) or none
    (baseline)."""
    return ResourcePool(build_inventory(
        n_pods=4, pod_size=8, hbm_per_accel_gb=192.0,
        n_memory_nodes=(0 if policy == "baseline" else 2),
        memory_node_gb=1024.0, interconnect=policy))
