"""Paged KV pool bookkeeping for the serving engine (port of the host
side of ``repro.core.tiering``, paper §5).

Tier-1 is the card's memory: a device-side page pool the engine owns.
Tier-2 is the capacity pool: a host-side cold store of page payloads.
``KVBudget`` sets the tier-1 page quota and the tier-2 byte budget;
``PagedKV`` owns the allocation state (free-page stack, per-sequence
logical->physical page maps, page-granular evict/fetch);
``TieringPolicy`` is the placement policy a pool lease hands the
runtime.  This is pure host bookkeeping, identical to the reference's;
the reference's ``jax.sharding`` offload helpers belong to the training
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KVBudget:
    """Budgeted KV-cache residency: serving capacity is an explicitly
    *quota'd*, contended resource (the DFabric / CXL-pooling framing),
    not a boolean.

    ``tier1_pages``: hot page quota across all engine slots (None =
    derived by the consumer, e.g. the engine's full slot capacity).
    ``tier2_bytes``: cold-pool byte budget on the capacity fabric —
    a lease derives this from its actual tier-2 KV grant.
    ``page_size``: tokens per KV page (bulk-friendly spill granularity).
    """

    tier1_pages: Optional[int] = None
    tier2_bytes: float = 0.0
    page_size: int = 64

    def pages_for(self, n_tokens) -> int:
        return max(1, -(-int(n_tokens) // self.page_size))

    def tier2_pages(self, page_bytes: float) -> int:
        if page_bytes <= 0:
            return 0
        return int(self.tier2_bytes // page_bytes)


class KVBudgetExceeded(RuntimeError):
    """A KV allocation would overrun the tier-1 page quota or the tier-2
    byte budget."""


@dataclasses.dataclass(frozen=True)
class TieringPolicy:
    """Which state lives in the capacity tier (§6: the paper evaluates
    weight + optimizer offloading as the common training optimization).
    Data only here: the serving engine reads ``kv_budget``; the training
    slice will act on the offload flags."""

    offload_optimizer: bool = True      # AdamW moments → tier-2
    offload_master_params: bool = False # fp32 masters → tier-2
    kv_budget: Optional[KVBudget] = None  # serving: budgeted KV paging

    @property
    def kv_spill(self) -> bool:
        """Deprecated boolean view of ``kv_budget`` (pre-engine API)."""
        return self.kv_budget is not None and self.kv_budget.tier2_bytes > 0

# ---------------------------------------------------------------------------
# paged KV pool: physical page allocator + page-granular tier-2 cold store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Page:
    """One logical KV page of one sequence: hot (a physical page id in
    the device pool) or cold (a host-side payload in the tier-2 store)."""

    phys: Optional[int] = None      # physical pool page id; None = cold
    payload: Any = None             # host pytree while cold

    @property
    def hot(self) -> bool:
        return self.phys is not None


class PagedKV:
    """Physical paged KV pool (serving-side tiering, paper §5).

    Owns the *allocation state* of a device-side page pool of
    ``budget.tier1_pages`` physical pages (accelerator HBM, the coherent
    tier-1): a free-page stack plus, per sequence (``rid``), the
    logical→physical page mapping the decode kernel's page table is
    built from.  Sequences need neither contiguous physical pages nor
    full residency: individual pages can be evicted to the tier-2 cold
    store (page-granular spill, counted against ``budget.tier2_bytes``)
    and fetched back into *different* physical pages later.

    The cold store is HOST-side (CPU tensors): paging decisions are
    host bookkeeping, and the evict/fetch payloads are explicit
    device↔pool bulk copies — the paper's CXL.io (no-coherence) tier-2
    path.  The caller (``repro_torch.serve.Engine``) owns the device arrays;
    ``evict`` takes the host copy it made of one page, ``fetch``
    allocates a fresh physical page and returns the payload for the
    caller to scatter back.  Operations that would overrun either
    budget raise ``KVBudgetExceeded`` and leave state untouched.
    """

    def __init__(self, budget: KVBudget, page_bytes: float):
        if budget.tier1_pages is None:
            raise ValueError("PagedKV needs a concrete tier-1 page quota")
        self.budget = budget
        self.page_bytes = float(page_bytes)
        self.num_pages = int(budget.tier1_pages)
        # stack: low ids pop first, so fresh allocations after churn land
        # on non-contiguous, reused pages (the layout the kernel must not
        # care about)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._seqs: Dict[Any, List[_Page]] = {}
        self.spills = 0                 # pages evicted tier-1 -> tier-2
        self.fetches = 0                # pages fetched tier-2 -> tier-1

    # ---- occupancy -------------------------------------------------------
    @property
    def hot_free(self) -> int:
        return len(self._free)

    @property
    def free_count(self) -> int:
        """Pages literally on the free stack — ``hot_free`` minus any
        revocation headroom a multi-tenant view folds in.  Cheap (no
        fair-share recomputation), for hot loops."""
        return len(self._free)

    def allowance(self) -> int:
        """Hot pages this pool's consumer may keep scheduled right now.
        For a private pool that is the whole quota; a multi-tenant view
        (an arbiter) overrides it with the tenant's current
        max-min fair share, which is what makes shares *revocable*."""
        return self.num_pages

    def hot_used(self) -> int:
        """Hot pages held by this pool's own sequences (== pool-wide
        usage for a private pool; per-tenant usage under an arbiter)."""
        return sum(1 for pages in self._seqs.values()
                   for p in pages if p.hot)

    @property
    def hot_pages_used(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def cold_pages_used(self) -> int:
        return sum(1 for pages in self._seqs.values()
                   for p in pages if not p.hot)

    @property
    def cold_bytes_used(self) -> float:
        return self.cold_pages_used * self.page_bytes

    def tier2_free_pages(self) -> int:
        """How many more pages the tier-2 byte budget can absorb."""
        if self.page_bytes <= 0:
            return 0
        room = self.budget.tier2_bytes - self.cold_bytes_used
        return max(0, int((room + 1e-6) // self.page_bytes))

    def holds(self, rid) -> bool:
        return rid in self._seqs

    def pages_of(self, rid) -> int:
        """Total logical pages (hot + cold) held by ``rid``."""
        return len(self._seqs[rid])

    def hot_count(self, rid) -> int:
        return sum(1 for p in self._seqs[rid] if p.hot)

    def cold_logicals(self, rid) -> List[int]:
        """Logical indices of ``rid``'s cold pages (ascending)."""
        return [i for i, p in enumerate(self._seqs[rid]) if not p.hot]

    def hot_logicals(self, rid) -> List[int]:
        return [i for i, p in enumerate(self._seqs[rid]) if p.hot]

    def is_fully_hot(self, rid) -> bool:
        return all(p.hot for p in self._seqs[rid])

    def page_table(self, rid) -> List[Optional[int]]:
        """Logical -> physical ids (None where cold) — the row the engine
        writes into the device page-table array."""
        return [p.phys for p in self._seqs[rid]]

    # ---- lifecycle -------------------------------------------------------
    def prepare(self, n_pages: int) -> None:
        """Hint that ``n_pages`` physical pages are about to be taken
        one at a time (a fetch loop).  No-op for a private pool; a
        multi-tenant view revokes the whole shortfall in ONE batched
        episode here, so the victim is charged one bulk transfer rather
        than a per-page setup latency per fetch."""

    def _take(self, n: int, what: str) -> List[int]:
        if n > len(self._free):
            raise KVBudgetExceeded(
                f"{what}: {n} pages > {len(self._free)} free of "
                f"{self.num_pages}-page tier-1 pool")
        return [self._free.pop() for _ in range(n)]

    def alloc(self, rid, n_pages: int) -> List[int]:
        """Admit ``rid`` with ``n_pages`` hot pages; returns their
        physical ids (in logical order)."""
        if rid in self._seqs:
            raise KeyError(f"{rid!r} already holds KV pages")
        phys = self._take(n_pages, repr(rid))
        self._seqs[rid] = [_Page(phys=p) for p in phys]
        return phys

    def grow(self, rid, n_total: int) -> List[int]:
        """Extend ``rid`` to ``n_total`` logical pages (decode crossed a
        page boundary); returns the new physical ids."""
        pages = self._seqs[rid]
        extra = n_total - len(pages)
        if extra <= 0:
            return []
        phys = self._take(extra, f"{rid!r} growth to {n_total}")
        pages.extend(_Page(phys=p) for p in phys)
        return phys

    def evict(self, rid, logical: int, payload) -> int:
        """Spill one hot page to the tier-2 cold store; returns the freed
        physical id.  ``payload`` is the caller's host copy of the page."""
        page = self._seqs[rid][logical]
        if not page.hot:
            raise KeyError(f"{rid!r} page {logical} already cold")
        if (self.cold_pages_used + 1) * self.page_bytes \
                > self.budget.tier2_bytes + 1e-6:
            raise KVBudgetExceeded(
                f"{rid!r}: evicting page {logical} overruns the "
                f"{self.budget.tier2_bytes / 1e9:.2f}GB tier-2 budget")
        phys = page.phys
        self._free.append(phys)
        page.phys, page.payload = None, payload
        self.spills += 1
        return phys

    def fetch(self, rid, logical: int) -> Tuple[int, Any]:
        """Bring one cold page back: allocates a fresh physical page
        (almost surely a *different* id) and returns ``(phys, payload)``
        for the caller to scatter into the device pool."""
        page = self._seqs[rid][logical]
        if page.hot:
            raise KeyError(f"{rid!r} page {logical} already hot")
        phys = self._take(1, f"{rid!r} fetch of page {logical}")[0]
        payload = page.payload
        page.phys, page.payload = phys, None
        self.fetches += 1
        return phys, payload

    def free(self, rid) -> None:
        """Release every page (hot ids back to the free stack, cold
        payloads dropped)."""
        for page in self._seqs.pop(rid, []):
            if page.hot:
                self._free.append(page.phys)

    def residency(self) -> Dict[str, float]:
        """Page-pool residency — the quantity ``Engine.stats()`` reports."""
        hot_seqs = sum(1 for pages in self._seqs.values()
                       if all(p.hot for p in pages))
        return {
            "tier1_pages_used": self.hot_pages_used,
            "tier1_pages_free": self.hot_free,
            "tier1_pages_quota": self.num_pages,
            "tier2_bytes_used": self.cold_bytes_used,
            "tier2_bytes_budget": self.budget.tier2_bytes,
            "seqs": len(self._seqs),
            "hot_seqs": hot_seqs,
            "partial_seqs": len(self._seqs) - hot_seqs,
            "spills": self.spills,
            "fetches": self.fetches,
        }
