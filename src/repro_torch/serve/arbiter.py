"""Multi-tenant fair-share arbitration over ONE physical KV page pool
(port of ``repro.serve.arbiter``).

Several tenant ``Engine``s draw hot KV pages from a single shared device
page pool (and their cold pages from per-tenant slices of one tier-2
grant) instead of carving the pool into static per-tenant partitions.
The ``PoolArbiter`` owns the shared free-page stack and the device pool
tensors; each tenant engine sees the pool through a ``_TenantKV`` view
whose *allowance* is a revocable *max-min fair share* over the live
tenants, not a fixed quota:

* **work conservation** — shares are demand-weighted (water-filling):
  a tenant wanting less than its equal split donates the surplus, and
  free pages beyond everyone's entitlement are usable by anybody, so a
  lone tenant gets the entire pool;
* **revocation** — when a tenant allocates under its share and the
  pool is dry, the arbiter evicts the coldest *paused* pages of the
  most-over-share tenant into that tenant's tier-2 budget (or drops a
  victim sequence for recompute when the budget is exhausted), and the
  swap seconds are charged to the *victim's* clock at its next step;
* **single-tenant transparency** — with one registered tenant the
  share is the whole pool, revocation never fires, and the engine's
  behavior is bit-identical to its private-``PagedKV`` path.

Tenants share only the *memory estate* (tier-1 pages + tier-2 bytes);
each engine keeps its own slots, compute and modeled clock.  Every
decision is host bookkeeping identical to the reference's; the pool
tensors live on the first tenant's device and every tenant writes them
in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis import tiebreak
from repro_torch.core.tiering import KVBudget, KVBudgetExceeded, PagedKV
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import CAT_ARBITER, resolve


def _device_key(dev: torch.device) -> Tuple[str, int]:
    """``cuda`` and ``cuda:0`` name one card (the current one is 0)."""
    return dev.type, dev.index or 0


class _TenantKV(PagedKV):
    """One tenant's view of the shared pool: the ``PagedKV`` interface
    the engine already speaks, but the free-page stack is the arbiter's
    (shared), ``allowance()`` is the tenant's live fair share, and a
    ``_take`` shortfall triggers cross-tenant revocation instead of
    failing."""

    def __init__(self, arbiter: "PoolArbiter", tenant: str,
                 tier2_bytes: float):
        # no super().__init__: the free stack belongs to the arbiter
        self.budget = KVBudget(tier1_pages=arbiter.num_pages,
                               tier2_bytes=tier2_bytes,
                               page_size=arbiter.page_size)
        self.page_bytes = float(arbiter.page_bytes)
        self.num_pages = arbiter.num_pages
        self._free = arbiter._free          # SHARED free-page stack
        self._seqs: Dict[Any, list] = {}
        self.spills = 0
        self.fetches = 0
        self._arbiter = arbiter
        self.tenant = tenant

    @property
    def hot_free(self) -> int:
        """Pages this tenant can obtain right now without evicting its
        own sequences: the shared free stack plus whatever its unmet
        share entitles it to revoke from over-share tenants."""
        return len(self._free) + self._arbiter.revocable_for(self.tenant)

    def allowance(self) -> int:
        return self._arbiter.allowance(self.tenant)

    def prepare(self, n_pages: int) -> None:
        if n_pages > len(self._free):
            self._arbiter.reclaim(self.tenant, n_pages)

    def _take(self, n: int, what: str) -> List[int]:
        if n > len(self._free):
            self._arbiter.reclaim(self.tenant, n)
        return super()._take(n, what)

    def residency(self) -> Dict[str, float]:
        r = super().residency()
        r["tier1_pages_used"] = self.hot_used()      # tenant, not pool
        # the PHYSICAL free stack, not hot_free: the revocable headroom
        # folded into hot_free is resident in other tenants' pages
        r["tier1_pages_free"] = self.free_count
        r["tier1_pages_revocable"] = self._arbiter.revocable_for(self.tenant)
        r["tier1_pages_pool_used"] = self.num_pages - self.free_count
        r["tenant"] = self.tenant
        return r


@dataclasses.dataclass
class _Tenant:
    name: str
    engine: Any                     # repro_torch.serve.Engine
    kv: _TenantKV
    charge_s: float = 0.0           # pending revocation swap-seconds
    charged_total_s: float = 0.0


class PoolArbiter:
    """Owns the shared device page pool and arbitrates it max-min
    fairly across tenant engines.  Construct with the pool geometry,
    then build each tenant with ``Engine.local(..., arbiter=arb,
    tenant="a")`` / ``Engine.from_lease(..., arbiter=arb, tenant="a")``
    — registration is implicit and the first tenant's cache shapes and
    device fix the pool's physical layout."""

    _TRACK = "pool:arbiter"

    def __init__(self, tier1_pages: int, *, page_size: int = 64,
                 tracer=None):
        if tier1_pages <= 0:
            raise ValueError("arbiter needs a positive tier-1 page quota")
        self.tracer = resolve(tracer)
        self.num_pages = int(tier1_pages)
        self.page_size = int(page_size)
        self.page_bytes = 0.0               # fixed at first registration
        # identical discipline to a private PagedKV: low ids pop first
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._tenants: Dict[str, _Tenant] = {}
        self.pool: Optional[Dict[str, torch.Tensor]] = None   # (+trash)
        self.device: Optional[torch.device] = None
        self._leaf_sig: Optional[Tuple] = None
        self.revoked_pages = 0              # pages evicted by revocation
        self.revocations = 0                # revocation episodes
        self.recompute_drops = 0            # victims dropped (no headroom)

    # ---- registration ----------------------------------------------------
    def register(self, tenant: str, engine, *, slot_shapes, page_bytes: float,
                 tier2_bytes: float = 0.0) -> _TenantKV:
        """Join ``engine`` as ``tenant``.  ``slot_shapes``: the engine's
        one-slot cache leaves ``(layers, 1, max_seq, ...)`` (meta
        tensors); the first tenant's fix the pool, allocated with
        ``torch.zeros`` on its device as ``(layers, num_pages + 1, page,
        ...)`` with the trash page last."""
        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} already registered")
        if engine.cfg.page_size != self.page_size:
            raise ValueError(
                f"tenant {tenant!r}: engine page_size "
                f"{engine.cfg.page_size} != arbiter page_size "
                f"{self.page_size} — one pool, one page geometry")
        # leaves in sorted name order, as the reference's pytree walk
        # visits dict keys: a tenant whose cache lists the same leaves in
        # another order serves the same layout
        leaves = sorted(slot_shapes.items())
        sig = tuple((name, (l.shape[0], self.page_size) + tuple(l.shape[3:]),
                     l.dtype) for name, l in leaves)
        if self.pool is None:
            self.page_bytes = float(page_bytes)
            self._leaf_sig = sig
            self.device = engine.device
            self.pool = {
                name: torch.zeros((l.shape[0], self.num_pages + 1,
                                   self.page_size) + tuple(l.shape[3:]),
                                  dtype=l.dtype, device=self.device)
                for name, l in leaves}
        elif sig != self._leaf_sig:
            raise ValueError(
                f"tenant {tenant!r}: KV cache layout {sig} does not match "
                f"the shared pool's {self._leaf_sig} — tenants of one "
                f"physical pool must serve the same cache geometry")
        elif _device_key(engine.device) != _device_key(self.device):
            raise ValueError(
                f"tenant {tenant!r}: engine device {engine.device} is not "
                f"the shared pool's {self.device}")
        kv = _TenantKV(self, tenant, tier2_bytes)
        self._tenants[tenant] = _Tenant(tenant, engine, kv)
        if self.tracer.enabled and len(self._tenants) >= 2:
            # pool membership, re-announced per registration past the
            # first: a trace sanitizer switches its page conservation
            # check from per-engine to pool-wide on this event.  Gated on
            # >= 2 tenants so a lone tenant's traced stream stays
            # bit-identical to the private-pool path.  register() runs
            # inside Engine.__init__ BEFORE the engine's clock exists.
            self.tracer.instant(self._TRACK, "pool_tenants",
                                getattr(engine, "clock", 0.0),
                                cat=CAT_ARBITER, pages=self.num_pages,
                                tenants=sorted(self._tenants))
        return kv

    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._tenants)

    def check_conservation(self) -> None:
        """Raise ``AssertionError`` unless every physical page is either
        on the free stack or hot in exactly one tenant's sequence, and
        every running row's device page table maps its logical pages
        onto its own sequence's physical pages (the rest on the trash
        page).  Tenants' page tables then never alias a live page."""
        def fail(msg: str) -> None:
            raise AssertionError(f"pool page check: {msg}")

        owner: Dict[int, Tuple[str, Any]] = {}
        for n, t in sorted(self._tenants.items()):
            for rid in list(t.kv._seqs):
                for phys in t.kv.page_table(rid):
                    if phys is None:
                        continue
                    if phys in owner:
                        fail(f"page {phys} held by {owner[phys]} and "
                             f"{(n, rid)}")
                    owner[phys] = (n, rid)
            for slot, st in enumerate(t.engine._slots):
                if st is None:
                    continue
                table = t.kv.page_table(st.rid)
                row = t.engine._table[slot].tolist()
                if row[:len(table)] != table or any(
                        p != t.engine._trash for p in row[len(table):]):
                    fail(f"{n}: row {slot} table {row} != {table} + trash")
        free = set(self._free)
        if len(free) != len(self._free):
            fail("the free stack repeats a page")
        if free & set(owner):
            fail(f"pages {sorted(free & set(owner))} free and held")
        if free | set(owner) != set(range(self.num_pages)):
            fail("pages lost from the pool")

    # ---- fair shares -----------------------------------------------------
    def _shares(self) -> Dict[str, int]:
        """Max-min fair (water-filling) page shares over live tenants:
        equal split, with tenants demanding less than their level
        donating the surplus to the still-unsatisfied."""
        # registration-order enumeration is incidental: every decision
        # below reduces through sorted() or integer arithmetic, and the
        # tiebreak seam permutes these builds to prove it
        demands = {n: min(t.engine._page_demand(), self.num_pages)
                   for n, t in tiebreak.order(self._tenants.items())}
        shares = {n: 0 for n in self._tenants}
        pending = {n: d for n, d in tiebreak.order(demands.items())
                   if d > 0}
        remaining = self.num_pages
        while pending:
            level = remaining // len(pending)
            sat = [n for n, d in tiebreak.order(pending.items())
                   if d <= level]
            if not sat:
                # nobody saturates at this level: split evenly, the
                # integer remainder going one page each to the first
                # tenants in name order — flooring it away would leave
                # pages outside every share, un-revocable by anyone
                rem = remaining - level * len(pending)
                for i, n in enumerate(sorted(pending)):
                    shares[n] = level + (1 if i < rem else 0)
                break
            for n in sorted(sat):
                shares[n] = pending.pop(n)
                remaining -= shares[n]
        return shares

    def _allowances(self) -> Dict[str, int]:
        """Share plus any free pages nobody else is entitled to — the
        quantity a tenant may keep *scheduled*.  Exceeding it is legal
        only until somebody under-share allocates (revocation)."""
        shares = self._shares()
        used = {n: t.kv.hot_used()
                for n, t in tiebreak.order(self._tenants.items())}
        free = len(self._free)
        out = {}
        for n in self._tenants:
            deficit = sum(max(0, shares[u] - used[u])
                          for u in self._tenants if u != n)
            out[n] = min(self.num_pages,
                         shares[n] + max(0, free - deficit))
        return out

    def allowance(self, tenant: str) -> int:
        return self._allowances()[tenant]

    def _evictable_over(self, allowances: Dict[str, int]) -> Dict[str, int]:
        """Per tenant: hot pages held beyond allowance that are actually
        revocable (pages of *paused* sequences — running rows are never
        yanked mid-decode)."""
        out = {}
        for n, t in tiebreak.order(self._tenants.items()):
            over = t.kv.hot_used() - allowances[n]
            if over <= 0:
                continue
            paused = sum(t.kv.hot_count(s.rid) for s in t.engine._paused
                         if t.kv.holds(s.rid))
            if paused > 0:
                out[n] = min(over, paused)
        return out

    def revocable_for(self, tenant: str) -> int:
        """Pages ``tenant`` could claim by revocation right now: capped
        by its own unmet share (an over-share tenant revokes nobody)."""
        allowances = self._allowances()
        deficit = allowances[tenant] - self._tenants[tenant].kv.hot_used()
        if deficit <= 0:
            return 0
        evictable = sum(v for n, v in
                        self._evictable_over(allowances).items()  # repro: allow(no-unordered-iteration) integer sum — exact and commutative in any order
                        if n != tenant)
        return min(deficit, evictable)

    # ---- revocation ------------------------------------------------------
    def reclaim(self, tenant: str, need: int) -> None:
        """Free pages until the shared stack holds ``need``, by evicting
        the coldest paused pages of the most-over-share tenant into ITS
        tier-2 budget (swap seconds charged to ITS clock), or dropping
        a victim sequence for recompute when it has no tier-2 headroom.
        ``tenant`` (the requester) pays nothing.  The victim's pages are
        copied to the host (a blocking copy) before the requester's
        writes can reuse them."""
        # deferred import: engine consumes this module (arbiter= arg),
        # arbiter only needs engine's shared eviction helper
        from repro_torch.serve.engine import evict_pages

        allowances = self._allowances()     # frozen for this pass
        while len(self._free) < need:
            # victim selection is a TOTAL-order reduction — most pages
            # over share, ties to the lexicographically first tenant —
            # so the scan order over the tenant dict is irrelevant
            cands = []
            for u, t in tiebreak.order(self._tenants.items()):
                if u == tenant:
                    continue
                over = t.kv.hot_used() - allowances[u]
                if over <= 0:
                    continue
                paused = [s for s in t.engine._paused
                          if t.kv.holds(s.rid) and t.kv.hot_count(s.rid) > 0]
                if not paused:
                    continue
                cands.append((over, u, t, paused))
            best = (min(cands, key=lambda c: (-c[0], c[1]))
                    if cands else None)
            if best is None:
                raise KVBudgetExceeded(
                    f"{tenant!r}: revocation cannot free "
                    f"{need - len(self._free)} more pages — no over-share "
                    f"tenant holds evictable (paused) pages")
            over, u, t, paused = best
            victim = min(paused,
                         key=lambda s: (s.last_sched, s.admit_seq))
            hot = t.kv.hot_logicals(victim.rid)
            k = min(need - len(self._free), over, len(hot),
                    t.kv.tier2_free_pages())
            if k <= 0:
                # no tier-2 headroom: drop the victim's KV and requeue
                # it on ITS engine for re-prefill
                t.engine._drop_for_recompute(victim)
                self.recompute_drops += 1
                if self.tracer.enabled:
                    self.tracer.instant(self._TRACK, "recompute_drop",
                                        t.engine.clock, cat=CAT_ARBITER,
                                        victim=u, requester=tenant,
                                        rid=victim.rid, pages=len(hot))
                continue
            # the victim's pages ride ITS tier-2 route: the transfer is
            # registered on the victim engine's transport at its clock
            # (the charge lands on its next step via take_charge)
            cost = evict_pages(self.pool, t.kv, victim, hot[:k],
                               t.engine, t.engine.clock)
            t.charge_s += cost
            t.charged_total_s += cost
            self.revoked_pages += k
            self.revocations += 1
            if self.tracer.enabled:
                self.tracer.instant(self._TRACK, "revoke",
                                    t.engine.clock, cat=CAT_ARBITER,
                                    victim=u, requester=tenant, pages=k,
                                    rid=victim.rid, cost_s=cost)
                # the post-revocation fair shares, on revocation episodes
                # only (a lone tenant never revokes)
                for n, allow in sorted(self._allowances().items()):
                    self.tracer.counter(self._TRACK, f"allowance:{n}",
                                        t.engine.clock, float(allow),
                                        cat=CAT_ARBITER)

    def take_charge(self, tenant: str) -> float:
        """Collect (and clear) the swap seconds revocation charged to
        ``tenant`` since its last step — added to that step's dt so the
        victim's own event clocks absorb the traffic it caused."""
        t = self._tenants[tenant]
        dt, t.charge_s = t.charge_s, 0.0
        if dt > 0.0 and self.tracer.enabled:
            self.tracer.instant(self._TRACK, "charge", t.engine.clock,
                                cat=CAT_ARBITER, tenant=tenant, cost_s=dt)
        return dt

    # ---- observability ---------------------------------------------------
    _STATS_KEYS = ("tier1_pages_quota", "tier1_pages_free", "revoked_pages",
                   "revocations", "recompute_drops")
    _TENANT_KEYS = ("hot_used", "cold_pages", "share", "allowance",
                    "demand", "spills", "fetches", "revocation_charged_s")

    def metrics(self, registry: Optional[MetricsRegistry] = None,
                prefix: str = "arbiter") -> MetricsRegistry:
        """Fill (and return) a metrics registry with the pool-wide and
        per-tenant arbitration state under ``arbiter/...``; ``stats()``
        is a thin adapter over it."""
        reg = registry if registry is not None else MetricsRegistry()
        allowances = self._allowances()
        shares = self._shares()
        reg.set(f"{prefix}/tier1_pages_quota", self.num_pages)
        reg.set(f"{prefix}/tier1_pages_free", len(self._free))
        reg.set(f"{prefix}/revoked_pages", self.revoked_pages)
        reg.set(f"{prefix}/revocations", self.revocations)
        reg.set(f"{prefix}/recompute_drops", self.recompute_drops)
        for n, t in sorted(self._tenants.items()):
            tp = f"{prefix}/tenant/{n}"
            reg.set(f"{tp}/hot_used", t.kv.hot_used())
            reg.set(f"{tp}/cold_pages", t.kv.cold_pages_used)
            reg.set(f"{tp}/share", shares[n])
            reg.set(f"{tp}/allowance", allowances[n])
            reg.set(f"{tp}/demand", t.engine._page_demand())
            reg.set(f"{tp}/spills", t.kv.spills)
            reg.set(f"{tp}/fetches", t.kv.fetches)
            reg.set(f"{tp}/revocation_charged_s", t.charged_total_s)
        return reg

    def stats(self) -> Dict[str, Any]:
        """Nested dict, adapted off the ``metrics()`` registry."""
        snap = self.metrics().snapshot("arbiter/")
        out: Dict[str, Any] = {k: snap[f"arbiter/{k}"]
                               for k in self._STATS_KEYS}
        out["tenants"] = {
            n: {k: snap[f"arbiter/tenant/{n}/{k}"]
                for k in self._TENANT_KEYS}
            for n in sorted(self._tenants)
        }
        return out
