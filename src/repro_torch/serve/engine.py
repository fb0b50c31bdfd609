"""Request-level continuous-batching engine over a *physically paged*,
budgeted KV pool (port of ``repro.serve.engine``).

One ``Engine`` owns a shared device-side KV **page pool**
(``KVBudget.tier1_pages`` physical pages of ``page_size`` tokens, plus
one trash page that absorbs idle rows' writes), a slot array of decode
rows, and a per-row page table (``int32[max_slots, pages_per_slot]``)
mapping each sequence's logical pages onto arbitrary physical pages.
Decode is ONE batched call into the model's paged path: the paged
attention kernel gathers K/V through the page table, so a sequence
needs neither contiguous pages nor a reserved slab.

Scheduling per ``step()``:

* pressure relief: if the running rows' next-token page demand exceeds
  the pool, the newest-admitted rows are *paused* (their pages stay hot
  until somebody needs them: lazy, page-granular eviction).  Growth
  allocations then evict the **coldest pages** (least-recently-scheduled
  paused sequence first; within it the lowest-logical pages first) to
  the tier-2 cold store over the capacity fabric — or, with no tier-2
  byte headroom, drop the victim's KV entirely and requeue it for
  re-prefill;
* swap-in: paused sequences re-enter in pause order (oldest first);
  only their *cold* pages ride the fabric back, into whatever physical
  pages are free;
* admission: FIFO prefill, padded to a power-of-two page-aligned
  *bucket*, with the next-token logits read at the last real position;
* decode: every running row advances one token in a single call, rows
  gathered into a power-of-two row bucket.

Every event clock is the event's **modeled completion time**: a
``ServeCostModel`` prices prefill/decode from the paper's fabric
constants and page traffic is charged through a
``repro_torch.fabric.Transport`` — a private degenerate one by default,
or a shared routed one (``transport=``/``route=``) on which several
engines' transfers fair-share the links — so the schedule, the clocks
and the trace events are the reference's exactly whenever the tokens
are.

Disaggregated prefill/decode (``repro_torch.disagg``): a prefill-tier
engine runs ``prefill_export`` (the admission prefill, exported page by
page instead of scattered into its pool), and a decode-tier engine takes
the request through ``submit_prefilled``: admission waits for the first
pages to land on the modeled fabric, and the row's first decode waits
for the last.

Multi-tenant: ``arbiter=``/``tenant=`` joins a shared
``repro_torch.serve.PoolArbiter`` page pool instead of owning a private
one — ``self.kv`` becomes the tenant's fair-share view, the pool
tensors live on the arbiter (``self._pool`` reads and writes them), and
``allowance()`` (the live max-min share) replaces the fixed quota in
the pressure/resume decisions.  A lone tenant's allowance is the whole
pool, so it behaves bit for bit as a private engine.

The pool tensors are updated IN PLACE (``copy_``, ``index_copy_``,
``index_put_``) where the reference builds functional copies; the pool
contents are the same.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tiering import KVBudget, PagedKV
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import Model
from repro_torch.models.transformer import dtype_of
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import CAT_ENGINE, CAT_KV, CAT_REQUEST, resolve
from repro_torch.serve.api import (EngineConfig, Request, RequestHandle,
                                   RequestStatus, ServeCostModel)
from repro_torch.sharding.profiles import grid_refusal


def _pow2_buckets(start: int, cap: int) -> List[int]:
    """Doubling sizes from ``start`` up to (and always including) ``cap``."""
    out: List[int] = []
    b = start
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


def evict_pages(pool, kv, st, logicals, engine, t) -> float:
    """Spill one batch of ``st``'s hot logical pages to ``kv``'s tier-2
    cold store: gather the physical pages from the device pool (one
    bulk copy to the host), evict each, and record one swap episode on
    the handle.  The transfer is charged on ``engine``'s transport at
    modeled time ``t``; returns the modeled swap seconds."""
    table = kv.page_table(st.rid)
    idx = torch.as_tensor([table[lp] for lp in logicals],
                          device=engine.device)
    gathered = {name: leaf[:, idx].cpu() for name, leaf in pool.items()}
    for i, lp in enumerate(logicals):
        kv.evict(st.rid, lp, {name: g[:, i] for name, g in gathered.items()})
    st.handle.swaps += 1        # one spill episode: len(logicals) pages,
                                # one bulk transfer over the capacity fabric
    cost = engine.charge_tier2(len(logicals) * kv.page_bytes, t)
    if engine.tracer.enabled:
        engine.tracer.span(engine._track, "spill", t, cost, cat=CAT_KV,
                           rid=st.rid, pages=len(logicals),
                           bytes=len(logicals) * kv.page_bytes)
    return cost


def slice_page(cache, i: int, page_size: int):
    """Payload of logical page ``i`` of a dense ``(layers, 1, seq, ...)``
    prefill cache: ``(layers, page_size, ...)`` leaves — the per-page
    shape ``PagedKV.evict``/``fetch`` payloads use.  The leaves are views
    of ``cache`` (the reference's are copies); ``prefill_export`` clones
    them."""
    return {name: leaf[:, 0, i * page_size:(i + 1) * page_size]
            for name, leaf in cache.items()}


@dataclasses.dataclass(eq=False)        # identity semantics: these live in
class _SlotState:                        # queues/sets and are never "equal"
    """Host-side bookkeeping for one in-flight request."""

    handle: RequestHandle
    index: int = 0                 # next KV write position (= current length)
    cur_tok: int = 0               # last emitted token (decode input)
    slot: Optional[int] = None     # row in the slot array, None when off
    admit_seq: int = -1            # admission order (pressure pauses
                                   # newest-admitted rows first)
    last_sched: int = -1           # step() count of the last decode — the
                                   # page-coldness signal for eviction
    ready_at: float = 0.0          # modeled completion time of the LAST
                                   # in-flight KV page (disaggregated
                                   # handoff); decode never schedules the
                                   # row before it.  0.0 == colocated.
    on_first_decode: Optional[Any] = None   # one-shot callback fired with
                                   # the modeled time of the row's first
                                   # decode (the disagg handoff_use event)

    @property
    def rid(self) -> int:
        return self.handle.rid

    @property
    def request(self) -> Request:
        return self.handle.request

    def effective_prompt(self) -> Tuple[int, ...]:
        """Prompt for (re-)prefill: original prompt plus everything
        already generated (the recompute-preemption continuation)."""
        return self.request.prompt_tokens + tuple(self.handle.tokens)

    @property
    def target_len(self) -> int:
        return self.request.prompt_len + self.request.max_new_tokens


@dataclasses.dataclass(eq=False)
class _Handoff:
    """One externally-prefilled sequence waiting for decode-side
    admission (``Engine.submit_prefilled``): the per-page payloads in
    flight over the fabric plus the modeled arrival gates."""

    state: _SlotState
    pages: List[Any]               # slice_page payloads, logical order
    page_ready: List[float]        # modeled transfer completion per page
    admit_at: float                # gate: first min_ready pages landed
    ready_at: float                # gate: ALL pages landed (decode start)


def _check_device(model: Model, dev: torch.device) -> None:
    if dev.type != model.device.type:
        raise ValueError(f"engine device {dev} differs from the "
                         f"model's {model.device}")


class Engine:
    """Continuous-batching serving engine.  Build with ``Engine.local``
    (explicit config) or ``Engine.from_lease`` (a ``repro_torch.pool``
    lease supplies the device and the tier-2 KV byte budget)."""

    def __init__(self, model: Model, params, cfg: EngineConfig, *,
                 device: torch.device,
                 budget: Optional[KVBudget] = None,
                 cost_model: Optional[ServeCostModel] = None,
                 arbiter=None, tenant: Optional[str] = None,
                 transport=None, route=None, tracer=None):
        if not model.supports_paged_kv:
            raise NotImplementedError(
                f"Engine serves through the paged decode kernel, which "
                f"{model.cfg.family!r} does not implement")
        self.model = model
        self.device = device
        self.params = model.load(params)       # cast once, at load
        self.cfg = cfg
        # tier-2 transfer routing: a shared Transport (+ this engine's
        # route on it) makes concurrent tenants contend on the actual
        # links; without one, the engine owns a private degenerate
        # 1-link transport derived from its cost model
        if (transport is None) != (route is None):
            raise ValueError("pass transport= and route= together")
        self._transport = transport
        self._transport_owned = transport is None
        self.route = route
        # flight recorder: defaults to the shared transport's tracer
        self.tracer = resolve(tracer if tracer is not None
                              else getattr(transport, "tracer", None))
        self.cost = cost_model or ServeCostModel.from_fabric(
            2.0 * model.cfg.param_count())

        dt = dtype_of(cfg.cache_dtype)
        self._cache_dtype = dt
        slot_shapes = model.init_cache(1, cfg.max_seq, dtype=dt,
                                       device="meta")
        for leaf in slot_shapes.values():
            if leaf.dim() < 3 or leaf.shape[1] != 1 \
                    or leaf.shape[2] != cfg.max_seq:
                raise NotImplementedError(
                    f"paged serving expects (layers, batch=1, seq, ...) "
                    f"KV cache leaves, got {tuple(leaf.shape)}")
        slot_bytes = sum(l.numel() * l.element_size()
                         for l in slot_shapes.values())
        page_bytes = slot_bytes * cfg.page_size / max(1, cfg.max_seq)

        full = budget or KVBudget(page_size=cfg.page_size)
        self.arbiter = arbiter
        self.tenant = tenant
        if arbiter is not None:
            # multi-tenant: the arbiter owns the physical pool; this
            # engine's tier-1 "quota" is the whole pool, but its live
            # allowance is a revocable max-min fair share
            if self.tenant is None:
                self.tenant = f"tenant-{len(arbiter.tenants)}"
            self.budget = KVBudget(tier1_pages=arbiter.num_pages,
                                   tier2_bytes=full.tier2_bytes,
                                   page_size=cfg.page_size)
            self.kv = arbiter.register(self.tenant, self,
                                       slot_shapes=slot_shapes,
                                       page_bytes=page_bytes,
                                       tier2_bytes=full.tier2_bytes)
        else:
            tier1 = (full.tier1_pages if full.tier1_pages is not None
                     else cfg.max_slots * cfg.pages_per_slot)
            self.budget = KVBudget(tier1_pages=tier1,
                                   tier2_bytes=full.tier2_bytes,
                                   page_size=cfg.page_size)
            self.kv = PagedKV(self.budget, page_bytes)

        # physical page pool: leaf (layers, num_pages + 1, page, ...).
        # The extra page (id == num_pages) is the TRASH page: idle rows'
        # page tables point at it, so their decode writes land somewhere
        # harmless and their gathers stay in bounds.  Under an arbiter
        # the tensors live on the arbiter (ONE pool, N tenants, one
        # trash page they all write) and ``self._pool`` is a view.
        self._trash = self.kv.num_pages
        self._pool_store = None
        if arbiter is None:
            self._pool_store = {
                name: torch.zeros((l.shape[0], self.kv.num_pages + 1,
                                   cfg.page_size) + tuple(l.shape[3:]),
                                  dtype=l.dtype, device=device)
                for name, l in slot_shapes.items()}
        self._table = np.full((cfg.max_slots, cfg.pages_per_slot),
                              self._trash, np.int32)
        self._lengths = np.zeros(cfg.max_slots, np.int32)
        self._slot_tok = np.zeros(cfg.max_slots, np.int32)
        self._slots: List[Optional[_SlotState]] = [None] * cfg.max_slots

        self._queue: deque = deque()     # _SlotState, FIFO (+recompute front)
        self._paused: deque = deque()    # insertion-ordered: pause order IS
                                         # the resume order (oldest first)
        self._handoffs: deque = deque()  # _Handoff, FIFO: externally
                                         # prefilled sequences whose KV is
                                         # still riding the fabric
        self.handles: Dict[int, RequestHandle] = {}
        self._next_rid = 0
        self._admit_seq = 0

        self.clock = 0.0
        self.steps = 0
        self.busy_s = 0.0          # sum of nonzero step() durations: the
                                   # throughput denominator that idle
                                   # inter-arrival gaps cannot dilute
        self._decoded_tokens = 0

        # prefill buckets: page-aligned powers of two capped at the slot
        # capacity; decode row buckets: powers of two capped at max_slots
        self._buckets = _pow2_buckets(cfg.page_size,
                                      cfg.pages_per_slot * cfg.page_size)
        self._buckets_used: set = set()
        self._row_buckets = _pow2_buckets(1, cfg.max_slots)
        self._row_buckets_used: set = set()

    @property
    def _track(self) -> str:
        """This engine's trace track (one timeline row per tenant)."""
        return f"engine:{self.tenant}" if self.tenant else "engine"

    # the physical page pool: private tensors for a solo engine, the
    # arbiter's shared tensors when multi-tenant.  Every write (prefill
    # scatter, decode, spill gather, fetch) goes in place through this
    # view, so every tenant's hits the SAME pool.
    @property
    def _pool(self) -> Dict[str, torch.Tensor]:
        return (self.arbiter.pool if self.arbiter is not None
                else self._pool_store)

    # ---- transfer pricing --------------------------------------------------
    @property
    def cost(self) -> ServeCostModel:
        return self._cost

    @cost.setter
    def cost(self, cm: ServeCostModel) -> None:
        self._cost = cm
        if self._transport_owned:
            # the private degenerate transport prices from the cost
            # model's tier-2 scalars: rebuild lazily so ``eng.cost =
            # replace(cm, tier2_bw=...)`` keeps swap pricing in sync
            self._transport = None
            self.route = None

    @property
    def transport(self):
        """The ``repro_torch.fabric.Transport`` tier-2 traffic is charged
        through: the shared one passed in, or the private degenerate one
        built lazily from the cost model."""
        if self._transport is None:
            self._transport = self._cost.transport()
            self.route = self._transport.topology.route("src", "dst")
        return self._transport

    def charge_tier2(self, nbytes: float, t: float) -> float:
        """Modeled seconds for one bulk tier-2 transfer beginning at
        modeled time ``t``, fair-sharing links with every transfer
        already in flight on this engine's transport.  Flows are labeled
        ``serve:<tenant>``."""
        tx = self.transport            # materializes self.route too
        return tx.transfer_s(self.route, nbytes, t,
                             label=f"serve:{self.tenant or 'engine'}")

    # ---- construction ----------------------------------------------------
    @classmethod
    def local(cls, model: Model, cfg: EngineConfig = EngineConfig(), *,
              params=None, generator: Optional[torch.Generator] = None,
              budget: Optional[KVBudget] = None,
              cost_model: Optional[ServeCostModel] = None,
              arbiter=None, tenant: Optional[str] = None,
              transport=None, route=None, tracer=None,
              device: DeviceLike = None) -> "Engine":
        """Engine on one device (``None``: the card).  ``params`` default
        to ``model.init(generator)``; the KV budget is whatever the
        caller passes (default: unbudgeted tier-1, no tier-2).  Pass
        ``arbiter``/``tenant`` to join a shared multi-tenant page pool,
        and ``transport``/``route`` to charge tier-2 traffic on a shared
        routed fabric instead of a private degenerate link."""
        dev = resolve_device(device)
        _check_device(model, dev)
        if params is None:
            params = model.init(generator)
        return cls(model, params, cfg, device=dev, budget=budget,
                   cost_model=cost_model, arbiter=arbiter, tenant=tenant,
                   transport=transport, route=route, tracer=tracer)

    @classmethod
    def from_lease(cls, model: Model, lease,
                   cfg: EngineConfig = EngineConfig(), *,
                   params=None, generator: Optional[torch.Generator] = None,
                   budget: Optional[KVBudget] = None,
                   cost_model: Optional[ServeCostModel] = None,
                   arbiter=None, tenant: Optional[str] = None,
                   transport=None, route=None, tracer=None,
                   device: DeviceLike = None) -> "Engine":
        """Bind a ``repro_torch.pool.Lease``: the engine runs on the first
        device ``lease.materialize()`` binds (``device=`` picks it, e.g.
        ``"cpu"``), and the lease's tier-2 KV grant becomes the engine's
        ``KVBudget.tier2_bytes`` — serving capacity is composed by the
        orchestrator, not hard-coded per deployment.  The reference also
        derives sharding rules from the lease's mesh and scopes its jit
        programs to them; on one device there is nothing to shard, so
        the port has no counterpart of that step, and a lease whose mesh
        has a ``model`` axis over 1 (several cards bound) is refused
        (``profiles.grid_refusal``)."""
        binding = lease.materialize(None if device is None else [device])
        why = grid_refusal(binding, None, serving=True)
        if why is not None:
            raise ValueError(why)
        dev = binding.device
        _check_device(model, dev)
        if budget is None:
            if getattr(lease, "tenants", ()):
                # multi-tenant lease: this tenant's static slice of the
                # shared cold-store grant (tier-1 pages stay dynamic,
                # arbitrated by the arbiter).  kv_share raises on an
                # unknown tenant — falling back to the FULL grant would
                # let every mis-named tenant spill N x the cold bytes.
                budget = lease.kv_share(tenant, page_size=cfg.page_size)
            else:
                base = (binding.policy.kv_budget
                        or KVBudget(page_size=cfg.page_size))
                budget = KVBudget(tier1_pages=base.tier1_pages,
                                  tier2_bytes=base.tier2_bytes,
                                  page_size=cfg.page_size)
        if params is None:
            params = model.init(generator)
        return cls(model, params, cfg, device=dev, budget=budget,
                   cost_model=cost_model, arbiter=arbiter, tenant=tenant,
                   transport=transport, route=route, tracer=tracer)

    # ---- client API ------------------------------------------------------
    def submit(self, request: Request) -> RequestHandle:
        """Enqueue a request (deterministic FIFO admission order).

        Token ids are validated against the model vocab here: on the card
        an out-of-range id would be a device-side assert in the embedding
        gather, not a clean error."""
        if request.prompt_len + request.max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt {request.prompt_len} + max_new "
                f"{request.max_new_tokens} exceeds max_seq {self.cfg.max_seq}")
        vocab = self.model.cfg.vocab
        bad = [t for t in request.prompt_tokens if not 0 <= t < vocab]
        if bad:
            raise ValueError(
                f"prompt token id {bad[0]} outside the model vocab "
                f"[0, {vocab})")
        rid = self._next_rid
        self._next_rid += 1
        handle = RequestHandle(rid=rid, request=request,
                               submit_clock=max(self.clock,
                                                request.arrival_time))
        self.handles[rid] = handle
        self._queue.append(_SlotState(handle))
        if self.tracer.enabled:
            self.tracer.instant(self._track, "submit", handle.submit_clock,
                                cat=CAT_REQUEST, rid=rid,
                                prompt_len=request.prompt_len,
                                max_new=request.max_new_tokens)
        return handle

    # ---- disaggregated prefill/decode seams (repro_torch.disagg) ---------
    def prefill_export(self, prompt: Sequence[int]) -> Tuple[int, List[Any],
                                                             float]:
        """Prefill-only mode: run ONE bucketed prefill exactly as
        ``_admit`` would (``_run_prefill``: same bucket, same
        ``prefill_at`` call, same modeled cost, same last-position
        argmax) but export the KV page by page instead of scattering it
        into this engine's pool — the prefill half of the disaggregated
        handoff.  Returns ``(first_token, pages, modeled_seconds)``; the
        caller owns clock accounting, transfer pricing and decode-side
        admission.

        Each page's leaves are cloned, so a payload owns its bytes: a
        handoff in flight keeps its prompt's pages alive, not the whole
        dense bucket cache, and nothing aliases another page or a later
        prefill.  ``_write_page`` copies them into the decode engine's
        pool as it copies a colocated prefill's slices, so the pool gets
        the same bits either way."""
        plen = len(prompt)
        _, tok, cache, cost = self._run_prefill(prompt)
        ps = self.cfg.page_size
        pages = [{name: leaf.clone()
                  for name, leaf in slice_page(cache, i, ps).items()}
                 for i in range(-(-plen // ps))]
        return tok, pages, cost

    def submit_prefilled(self, request: Request, *, first_tok: int,
                         prefill_done: float, pages: List[Any],
                         page_ready: Sequence[float],
                         min_ready_pages: Optional[int] = None,
                         kv_transit_s: float = 0.0,
                         submit_clock: Optional[float] = None,
                         on_first_decode=None) -> RequestHandle:
        """Decode-only mode: hand off a request whose prefill ran on
        another engine (``prefill_export``) and whose KV pages are in
        flight on the fabric.  ``page_ready[i]`` is the modeled
        completion time of page ``i``'s transfer; admission waits for
        the first ``min_ready_pages`` pages to land (default: all —
        partial-arrival admission reserves the slot early), and the row
        is never decoded before max(page_ready): transferred-before-use
        is the invariant the ``disagg-handoff`` sanitizer rule checks.
        The first token was already produced by the prefill tier at
        modeled time ``prefill_done``."""
        if request.prompt_len + request.max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt {request.prompt_len} + max_new "
                f"{request.max_new_tokens} exceeds max_seq {self.cfg.max_seq}")
        if len(pages) != len(page_ready):
            raise ValueError(f"{len(pages)} pages but {len(page_ready)} "
                             f"ready times")
        if not pages:
            raise ValueError("handoff with no KV pages")
        rid = self._next_rid
        self._next_rid += 1
        handle = RequestHandle(rid=rid, request=request,
                               submit_clock=(submit_clock
                                             if submit_clock is not None
                                             else request.arrival_time))
        handle.kv_transit_s = kv_transit_s
        self.handles[rid] = handle
        st = _SlotState(handle)
        st.index = request.prompt_len
        st.cur_tok = first_tok
        st.on_first_decode = on_first_decode
        # the prefill tier produced the first token at prefill_done;
        # trace events on THIS track must stay monotone, so the finish
        # path (max_new == 1) clamps forward to the local clock
        handle.first_token_clock = prefill_done
        self._emit(st, first_tok, max(self.clock, prefill_done))
        if handle.done:
            return handle
        ready = [float(t) for t in page_ready]
        n_gate = (len(ready) if min_ready_pages is None
                  else max(1, min(min_ready_pages, len(ready))))
        self._handoffs.append(_Handoff(
            state=st, pages=list(pages), page_ready=ready,
            admit_at=max(ready[:n_gate]), ready_at=max(ready)))
        return handle

    @property
    def idle(self) -> bool:
        return (not self._queue and not self._paused and not self._handoffs
                and all(s is None for s in self._slots))

    def advance_clock(self, t: float) -> None:
        """Idle-advance modeled time (trace drivers jump to next arrival)."""
        self.clock = max(self.clock, t)

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError(f"engine not idle after {max_steps} steps")

    # ---- the engine loop -------------------------------------------------
    def step(self) -> float:
        """One scheduling round: relieve page pressure, swap in, admit,
        decode every running row one token.  Returns modeled seconds.
        Sub-phases receive the seconds already elapsed *within* this
        step so every event clock lands on the event's modeled time."""
        dt = 0.0
        if self.arbiter is not None:
            # swap seconds another tenant's revocation charged to us
            # since our last step: OUR pages rode the fabric, so OUR
            # subsequent event clocks absorb the time
            dt += self.arbiter.take_charge(self.tenant)
        dt += self._relieve_pressure(dt)
        dt += self._swap_in(dt)
        dt += self._admit_handoffs(dt)
        dt += self._admit(dt)
        dt += self._decode_once(dt)
        if (dt == 0.0 and self._queue and not self._paused  # repro: allow(no-float-equality) 0.0 is an exact no-work sentinel (no phase ran), never an accumulated time
                and all(s is None for s in self._slots)):
            # nothing runnable and the FIFO head has not arrived yet:
            # idle-advance to its arrival (the same jump run_trace makes)
            nxt = self._queue[0].request.arrival_time
            if nxt > self.clock:
                self.advance_clock(nxt)
        if dt == 0.0:  # repro: allow(no-float-equality) same exact no-work sentinel as above
            # every runnable row (or the pending handoff) is still
            # waiting on KV in flight over the fabric: idle-advance to
            # the earliest modeled page arrival so progress is made
            gates = [s.ready_at for s in self._slots
                     if s is not None and s.ready_at > self.clock]
            if self._handoffs:
                gates.append(self._handoffs[0].admit_at)
            if gates:
                nxt = min(gates)
                if nxt > self.clock:
                    self.advance_clock(nxt)
        self.clock += dt
        if dt > 0.0:
            self.busy_s += dt
        self.steps += 1
        if self.tracer.enabled:
            if self.steps == 1:
                # pool geometry, once: the conservation baseline a trace
                # sanitizer checks page counters against
                self.tracer.instant(self._track, "kv_pool", self.clock,
                                    cat=CAT_KV, pages=self.kv.num_pages)
            self.tracer.counter(self._track, "free_pages", self.clock,
                                float(self.kv.free_count), cat=CAT_KV)
            self.tracer.counter(self._track, "paused", self.clock,
                                float(len(self._paused)))
            self.tracer.counter(self._track, "allowance", self.clock,
                                float(self.kv.allowance()), cat=CAT_KV)
            # hot_pages LAST in the step-end block: the residency sample
            # checked as free + hot == pool against this block's
            # free_pages value
            self.tracer.counter(self._track, "hot_pages", self.clock,
                                float(self.kv.hot_used()), cat=CAT_KV)
        return dt

    # ---- internals -------------------------------------------------------
    def _running(self) -> List[_SlotState]:
        return sorted((s for s in self._slots if s is not None),
                      key=lambda s: s.admit_seq)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _pages_next(self, st: _SlotState) -> int:
        # pages needed to write the next token at position st.index; under
        # static reservation the full lifetime is held from admission on
        if self.cfg.reserve_lifetime:
            return self.budget.pages_for(st.target_len)
        return self.budget.pages_for(st.index + 1)

    def _page_demand(self) -> int:
        """This engine's current want for hot pages (running + paused
        next-token demand, plus the queue head's admission need) — the
        demand signal the arbiter's max-min water-filling splits the
        shared pool over."""
        d = sum(self._pages_next(s) for s in self._slots if s is not None)
        d += sum(self._pages_next(s) for s in self._paused)
        if self._queue:
            st = self._queue[0]
            if self.cfg.reserve_lifetime:
                d += self.budget.pages_for(st.target_len)
            else:
                d += self.budget.pages_for(len(st.effective_prompt()) + 1)
        return d

    def _bucket_len(self, plen: int) -> int:
        for b in self._buckets:
            if b >= plen:
                return b
        raise ValueError(f"prompt of {plen} exceeds slot capacity "
                         f"{self._buckets[-1]}")

    def prefill_compiles(self) -> int:
        """Distinct prefill shapes run: the buckets used.  A fresh
        reference engine compiles one XLA program per bucket, so the
        two counts agree; the port runs eagerly and compiles nothing."""
        return len(self._buckets_used)

    def decode_compiles(self) -> int:
        """Distinct decode row buckets run (see ``prefill_compiles``)."""
        return len(self._row_buckets_used)

    # ---- pressure relief / paging ----------------------------------------
    def _relieve_pressure(self, elapsed: float) -> float:
        """Deschedule newest-admitted rows until the remaining running
        rows' next-token demand fits the pool, then allocate this step's
        growth pages — evicting the coldest paused pages as needed."""
        dt = 0.0
        running = self._running()
        allow = self.kv.allowance()     # == num_pages for a private pool;
        while running:                  # the live fair share under an arbiter
            demand = sum(self._pages_next(s) for s in running)
            if demand <= allow and self._growth_deliverable(running):
                break
            self._pause(running.pop(),          # newest admission
                        self.clock + elapsed + dt)
        for st in running:
            want = self._pages_next(st)
            have = self.kv.pages_of(st.rid)
            if want > have:
                dt += self._make_room(want - have, t=elapsed + dt)
                new_phys = self.kv.grow(st.rid, want)
                for lp, phys in zip(range(have, want), new_phys):
                    self._table[st.slot, lp] = phys
        return dt

    def _growth_deliverable(self, running: List[_SlotState]) -> bool:
        """Can this step's growth pages actually be freed?  Sources: the
        free stack + revocation headroom (``hot_free``) plus our own
        paused sequences' hot pages.  For a private pool ``demand <=
        num_pages`` already implies it; under an arbiter another tenant
        may sit over its share with every row *running* (nothing
        revocable until ITS next step pauses them), and growing into
        that gap must wait."""
        growth = sum(max(0, self._pages_next(s) - self.kv.pages_of(s.rid))
                     for s in running if self.kv.holds(s.rid))
        own_evictable = sum(self.kv.hot_count(s.rid) for s in self._paused
                            if self.kv.holds(s.rid))
        return growth <= self.kv.hot_free + own_evictable

    def _pause(self, st: _SlotState, t: Optional[float] = None) -> None:
        """Deschedule a running row at modeled time ``t`` (defaults to
        the clock).  Costless: its pages STAY hot until an allocation
        actually needs them (lazy eviction)."""
        if self.tracer.enabled:
            self.tracer.instant(self._track, "pause",
                                self.clock if t is None else t,
                                cat=CAT_KV, rid=st.rid,
                                hot_pages=self.kv.hot_count(st.rid)
                                if self.kv.holds(st.rid) else 0)
        slot = st.slot
        self._table[slot, :] = self._trash
        self._lengths[slot] = 0
        self._slots[slot] = None
        st.slot = None
        st.handle.status = RequestStatus.SWAPPED
        st.handle.preempts += 1     # swaps counts actual tier-2 traffic,
                                    # charged at eviction time
        self._paused.append(st)     # insertion order == pause order

    def _make_room(self, n_pages: int, protect: Sequence[_SlotState] = (),
                   t: float = 0.0) -> float:
        """Free physical pages by evicting the coldest paused pages to
        tier-2 (or dropping victims for recompute when the byte budget
        is exhausted).  Coldness: least-recently-scheduled sequence
        first (admission order breaking ties); within a victim, the
        lowest-logical pages go first.  ``t`` is the seconds already
        elapsed within this step."""
        dt = 0.0
        # the revocation headroom, snapshotted once: under an arbiter
        # hot_free re-runs the water-filling over every tenant.  Own
        # evictions only grow the free stack, so the cached slack stays a
        # valid (conservative) lower bound.  Private pool: 0.
        slack = self.kv.hot_free - self.kv.free_count
        while self.kv.free_count + slack < n_pages:
            victims = [s for s in self._paused
                       if s not in protect and self.kv.hot_count(s.rid) > 0]
            if not victims:
                break               # nothing evictable; caller re-checks
            victim = min(victims, key=lambda s: (s.last_sched, s.admit_seq))
            dt += self._evict_or_drop(
                victim, n_pages - slack - self.kv.free_count, t + dt)
        return dt

    def _evict_or_drop(self, st: _SlotState, need: int, t: float) -> float:
        hot = self.kv.hot_logicals(st.rid)
        k = min(need, len(hot), self.kv.tier2_free_pages())
        if k <= 0:
            # no tier-2 headroom (or no tier-2 budget at all): drop the
            # whole sequence's KV and requeue it for re-prefill
            self._drop_for_recompute(st, self.clock + t)
            return 0.0
        return evict_pages(self._pool, self.kv, st, hot[:k], self,
                           self.clock + t)

    def _drop_for_recompute(self, st: _SlotState,
                            t: Optional[float] = None) -> None:
        if self.tracer.enabled:
            self.tracer.instant(self._track, "recompute_drop",
                                self.clock if t is None else t,
                                cat=CAT_KV, rid=st.rid,
                                generated=len(st.handle.tokens),
                                pages=self.kv.hot_count(st.rid)
                                if self.kv.holds(st.rid) else 0)
        self.kv.free(st.rid)
        st.index = 0
        st.handle.status = RequestStatus.QUEUED
        st.handle.recomputes += 1
        self._paused.remove(st)
        self._queue.appendleft(st)  # ahead of fresh arrivals

    def _swap_in(self, elapsed: float) -> float:
        """Paused sequences re-enter free rows in pause order (oldest
        paused first).  Only their COLD pages ride the fabric; still-hot
        pages never moved.  When nothing is running, the head of the
        pause queue may evict newer-paused pages to fit."""
        dt = 0.0
        allow = self.kv.allowance()
        run_demand = sum(self._pages_next(s) for s in self._slots
                         if s is not None)
        while self._paused:
            st = self._paused[0]
            slot = self._free_slot()
            if slot is None:
                break
            want = self._pages_next(st)
            if run_demand + want > allow:
                break       # resuming would overshoot the pool (flap guard)
            missing = (len(self.kv.cold_logicals(st.rid))
                       + max(0, want - self.kv.pages_of(st.rid)))
            if missing > self.kv.hot_free:
                if any(s is not None for s in self._slots):
                    break           # decode will free pages; wait
                dt += self._make_room(missing, protect=(st,),
                                      t=elapsed + dt)
                if missing > self.kv.hot_free:
                    break
            # resume BEFORE popping: mid-resume the sequence must stay
            # visible to the arbiter's demand accounting
            dt += self._resume_into(st, slot, want, elapsed + dt)
            self._paused.popleft()
            run_demand += want
        return dt

    def _resume_into(self, st: _SlotState, slot: int, want: int,
                     elapsed: float) -> float:
        dt = 0.0
        cold = self.kv.cold_logicals(st.rid)
        # reserve every physical page this resume needs in one go: under
        # an arbiter the per-page fetches would otherwise revoke (and
        # charge the victim a setup latency) once per cold page
        self.kv.prepare(len(cold) + max(0, want - self.kv.pages_of(st.rid)))
        if cold:
            fetched = [self.kv.fetch(st.rid, lp) for lp in cold]
            idx = torch.as_tensor([p for p, _ in fetched],
                                  device=self.device)
            for name, leaf in self._pool.items():   # one batched scatter
                stacked = torch.stack([pl[name] for _, pl in fetched],
                                      dim=1)
                leaf.index_copy_(1, idx, stacked.to(leaf.device, leaf.dtype))
            dt = self.charge_tier2(len(cold) * self.kv.page_bytes,
                                   self.clock + elapsed)
            if self.tracer.enabled:
                self.tracer.span(self._track, "fetch",
                                 self.clock + elapsed, dt, cat=CAT_KV,
                                 rid=st.rid, pages=len(cold),
                                 bytes=len(cold) * self.kv.page_bytes)
        self.kv.grow(st.rid, want)
        for lp, phys in enumerate(self.kv.page_table(st.rid)):
            self._table[slot, lp] = phys
        self._place(st, slot)
        return dt

    # ---- disaggregated handoff admission -----------------------------------
    def _admit_handoffs(self, elapsed: float) -> float:
        """Admit handed-off (externally prefilled) sequences whose
        leading KV pages have arrived: allocate physical pages, write
        every page payload through ``self._pool`` (the arbiter's shared
        pool when this engine is a tenant; arrived pages now, the rest
        gated by ``ready_at``, which decode scheduling honors), and
        place the row.  Runs after swap-in and before fresh admission —
        a handoff already spent prefill compute elsewhere, so it
        outranks a fresh arrival for free rows — but never past a
        blocked pause queue, mirroring ``_admit``."""
        dt = 0.0
        while self._handoffs:
            if self._paused:
                break
            ho = self._handoffs[0]
            st = ho.state
            if ho.admit_at > self.clock + elapsed + dt:
                break       # leading pages still in flight on the fabric
            need = (self.budget.pages_for(st.target_len)
                    if self.cfg.reserve_lifetime
                    else self.budget.pages_for(st.index + 1))
            slot = self._free_slot()
            if slot is None or need > self.kv.hot_free:
                break
            phys = self.kv.alloc(st.rid, need)
            for i, payload in enumerate(ho.pages):
                self._write_page(int(phys[i]), payload)
            for lp, p in enumerate(phys):
                self._table[slot, lp] = p
            self._place(st, slot)
            st.ready_at = ho.ready_at
            self._handoffs.popleft()
        return dt

    # ---- admission / prefill ---------------------------------------------
    def _admit(self, elapsed: float) -> float:
        """FIFO prefill admission (head-of-line blocking keeps the order
        deterministic; a request that can never fit fails immediately).
        Admission never runs past a blocked pause queue."""
        dt = 0.0
        while self._queue:
            if self._paused:
                break
            st = self._queue[0]
            if st.request.arrival_time > self.clock + elapsed + dt:
                break   # not arrived yet on the modeled clock
            if self.budget.pages_for(st.target_len) > self.kv.num_pages:
                self._queue.popleft()
                st.handle.status = RequestStatus.FAILED_OOM
                st.handle.done_clock = self.clock + elapsed + dt
                if self.tracer.enabled:
                    self.tracer.instant(self._track, "failed_oom",
                                        st.handle.done_clock,
                                        cat=CAT_REQUEST, rid=st.rid)
                continue
            slot = self._free_slot()
            eff = st.effective_prompt()
            need = (self.budget.pages_for(st.target_len)
                    if self.cfg.reserve_lifetime
                    else self.budget.pages_for(len(eff) + 1))
            if slot is None or need > self.kv.hot_free:
                break
            # prefill BEFORE popping: while its pages are allocated the
            # request must stay visible (as queue head) to the arbiter's
            # demand accounting
            dt += self._prefill_into(st, slot, eff, elapsed + dt)
            self._queue.popleft()
        return dt

    def _run_prefill(self, prompt: Sequence[int]
                     ) -> Tuple[int, int, Dict[str, torch.Tensor], float]:
        """The one bucketed prefill both admission (``_prefill_into``)
        and the disaggregated export (``prefill_export``) run: pad the
        prompt to its bucket, call ``prefill_at`` with the logits read at
        the last real position, price the bucket.  Returns ``(bucket,
        first_token, dense_cache, modeled_seconds)``."""
        plen = len(prompt)
        bucket = self._bucket_len(plen)
        self._buckets_used.add(bucket)
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :plen] = torch.as_tensor(prompt)
        slot_cache = self.model.init_cache(1, bucket,
                                           dtype=self._cache_dtype)
        logits, cache = self.model.prefill_at(
            self.params, {"tokens": tokens.to(self.device)}, slot_cache,
            plen - 1)
        # the padded tail is real (wasted) compute on hardware: charge it
        cost = self.cost.prefill_s(bucket)
        tok = int(torch.argmax(logits[0, -1]))
        return bucket, tok, cache, cost

    def _prefill_into(self, st: _SlotState, slot: int,
                      eff: Tuple[int, ...], elapsed: float) -> float:
        plen = len(eff)
        bucket, tok, cache, cost = self._run_prefill(eff)
        if self.tracer.enabled:
            self.tracer.span(self._track, "prefill",
                             self.clock + elapsed, cost, cat=CAT_ENGINE,
                             rid=st.rid, bucket=bucket, prompt_len=plen)
        self._emit(st, tok, self.clock + elapsed + cost)
        if st.handle.done:
            return cost
        need = (self.budget.pages_for(st.target_len)
                if self.cfg.reserve_lifetime
                else self.budget.pages_for(plen + 1))
        phys = self.kv.alloc(st.rid, need)
        self._write_prefill_pages(cache, phys, plen)
        for lp, p in enumerate(phys):
            self._table[slot, lp] = p
        st.index = plen
        st.cur_tok = tok
        self._place(st, slot)
        return cost

    def _write_page(self, phys: int, payload) -> None:
        """Write ONE page payload (the ``slice_page`` / ``PagedKV``
        per-page format) into physical page ``phys`` of the pool, in
        place and dtype-converting: prefill scatter, tier-2 fetch and the
        disaggregated handoff land identical bits."""
        for name, leaf in self._pool.items():
            leaf[:, phys].copy_(payload[name])

    def _write_prefill_pages(self, cache, phys: List[int],
                             plen: int) -> None:
        """Write the dense prefill cache into the allocated physical
        pages one page at a time.  Only pages holding real tokens are
        copied: the padded bucket tail (and any growth pages past the
        prompt) is never read, by the length mask."""
        ps = self.cfg.page_size
        for i in range(-(-plen // ps)):
            self._write_page(int(phys[i]), slice_page(cache, i, ps))

    def _place(self, st: _SlotState, slot: int) -> None:
        st.slot = slot
        st.admit_seq = self._admit_seq
        self._admit_seq += 1
        self._slots[slot] = st
        self._lengths[slot] = st.index
        self._slot_tok[slot] = st.cur_tok
        st.handle.status = RequestStatus.RUNNING

    # ---- decode ----------------------------------------------------------
    def _emit(self, st: _SlotState, tok: int, at: float) -> None:
        """Record a generated token at its modeled completion time."""
        st.handle.tokens.append(tok)
        if st.handle.first_token_clock is None:
            st.handle.first_token_clock = at
        eos_hit = (self.cfg.eos_token is not None
                   and tok == self.cfg.eos_token)
        if len(st.handle.tokens) >= st.request.max_new_tokens or eos_hit:
            st.handle.status = RequestStatus.DONE
            st.handle.done_clock = at
            if self.tracer.enabled:
                h = st.handle
                ttft = (h.first_token_clock - h.submit_clock
                        if h.first_token_clock is not None else 0.0)
                self.tracer.instant(self._track, "finish", at,
                                    cat=CAT_REQUEST, rid=h.rid,
                                    tokens=len(h.tokens))
                # one span per request lifetime on the request row
                extra = ({"kv_transit_s": h.kv_transit_s}
                         if h.kv_transit_s > 0.0 else {})
                self.tracer.span(f"{self._track}/requests", f"req{h.rid}",
                                 h.submit_clock, at - h.submit_clock,
                                 cat=CAT_REQUEST, rid=h.rid, ttft_s=ttft,
                                 tokens=len(h.tokens), swaps=h.swaps,
                                 preempts=h.preempts,
                                 recomputes=h.recomputes, **extra)
            if self.kv.holds(st.rid):
                self.kv.free(st.rid)
            if st.slot is not None:
                self._table[st.slot, :] = self._trash
                self._lengths[st.slot] = 0
                self._slots[st.slot] = None
                st.slot = None

    def _row_bucket(self, n_live: int) -> int:
        for b in self._row_buckets:
            if b >= n_live:
                return b
        raise AssertionError(f"{n_live} live rows > max_slots")

    def _decode_once(self, elapsed: float) -> float:
        # rows whose handed-off KV pages are still in flight on the
        # fabric are placed but not schedulable: decoding one would read
        # pages before their modeled transfer completion.  Colocated rows
        # have ready_at == 0.0, so the filter is the identity for them.
        running = [st for st in self._running()
                   if st.ready_at <= self.clock + elapsed]
        if not running:
            return 0.0
        for st in running:
            self._lengths[st.slot] = st.index
            self._slot_tok[st.slot] = st.cur_tok
            st.last_sched = self.steps
            if st.on_first_decode is not None:
                # first decode of a handed-off row: report the modeled
                # use time (>= every page's transfer completion)
                st.on_first_decode(self.clock + elapsed)
                st.on_first_decode = None
        # gather live rows into a pow2 row bucket: pad with idle slots
        # (trash page table, length 0), so the decode batch shrinks with
        # occupancy.  A dense row's output is the same in every bucket;
        # an moe row's is not under capacity drops (ROADMAP C-ref5): the
        # idle rows are routed too, with their slots' stale tokens, the
        # expert capacity grows with the bucket, and in the full bucket
        # (rows in slot order) an idle slot can take a live row's place.
        # So the bucket, the row order and the idle tokens are the
        # reference's
        bucket = self._row_bucket(len(running))
        self._row_buckets_used.add(bucket)
        rows = [st.slot for st in running]
        if bucket < self.cfg.max_slots:
            idle = [i for i, s in enumerate(self._slots) if s is None]
            sel = np.asarray(rows + idle[:bucket - len(rows)], np.int64)
        else:
            sel = np.arange(self.cfg.max_slots, dtype=np.int64)
            rows = list(sel)                # full array: row == slot
        dev = self.device
        toks = torch.as_tensor(self._slot_tok[sel][:, None],
                               dtype=torch.long).to(dev)
        table = torch.as_tensor(self._table[sel]).to(dev)
        lengths = torch.as_tensor(self._lengths[sel]).to(dev)
        logits, _ = self.model.decode_paged(self.params, toks, self._pool,
                                            table, lengths)
        new_toks = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        pos = {slot: i for i, slot in enumerate(rows)}
        cost = self.cost.decode_s(len(running))
        at = self.clock + elapsed + cost
        if self.tracer.enabled:
            self.tracer.span(self._track, "decode",
                             self.clock + elapsed, cost, cat=CAT_ENGINE,
                             rows=len(running), bucket=bucket)
        for st in running:
            tok = int(new_toks[pos[st.slot]])
            st.index += 1
            st.cur_tok = tok
            self._decoded_tokens += 1
            self._emit(st, tok, at)
        return cost

    # ---- observability ---------------------------------------------------
    # flat scalar keys of the stats() dict; each maps 1:1 onto the
    # registry path  serve/<tenant>/<key>
    _STATS_KEYS = ("clock_s", "steps", "busy_s", "queue_depth", "running",
                   "swapped", "completed", "failed_oom", "tokens_decoded",
                   "throughput_tok_s", "throughput_busy_tok_s", "preempts",
                   "preempt_swaps", "preempt_recomputes", "prefill_buckets",
                   "prefill_compiles", "decode_row_buckets",
                   "decode_compiles")

    def _metrics_prefix(self) -> str:
        return f"serve/{self.tenant or 'engine'}"

    def metrics(self, registry: Optional[MetricsRegistry] = None,
                prefix: Optional[str] = None) -> MetricsRegistry:
        """Fill (and return) a metrics registry with this engine's state
        under ``serve/<tenant>/...``; ``stats()`` is a thin adapter."""
        reg = registry if registry is not None else MetricsRegistry()
        p = prefix if prefix is not None else self._metrics_prefix()
        statuses = [h.status for h in self.handles.values()]
        pairs = (
            ("clock_s", self.clock),
            ("steps", self.steps),
            ("busy_s", self.busy_s),
            ("queue_depth", len(self._queue)),
            ("running", sum(s is not None for s in self._slots)),
            ("swapped", len(self._paused)),
            ("completed", sum(s is RequestStatus.DONE for s in statuses)),
            ("failed_oom",
             sum(s is RequestStatus.FAILED_OOM for s in statuses)),
            ("tokens_decoded", self._decoded_tokens),
            # offered-load rate: clock_s includes idle inter-arrival gaps
            ("throughput_tok_s", (self._decoded_tokens / self.clock
                                  if self.clock > 0 else 0.0)),
            # decode rate while the engine is actually working
            ("throughput_busy_tok_s", (self._decoded_tokens / self.busy_s
                                       if self.busy_s > 0 else 0.0)),
            ("preempts",
             sum(h.preempts for h in self.handles.values())),
            ("preempt_swaps",
             sum(h.swaps for h in self.handles.values())),
            ("preempt_recomputes",
             sum(h.recomputes for h in self.handles.values())),
            ("prefill_buckets", list(self._buckets)),
            ("prefill_compiles", self.prefill_compiles()),
            ("decode_row_buckets", list(self._row_buckets)),
            ("decode_compiles", self.decode_compiles()),
        )
        for key, value in pairs:
            reg.set(f"{p}/{key}", value)
        for key, value in self.kv.residency().items():
            reg.set(f"{p}/kv/{key}", value)
        # materializes the lazy private transport so the subtree is
        # schema-stable whether or not a swap ever happened
        self.transport.metrics(reg, prefix=f"{p}/transport")
        if self.arbiter is not None:
            reg.set(f"{p}/tenant", self.tenant)
            reg.set(f"{p}/allowance", self.kv.allowance())
        return reg

    def stats(self) -> Dict[str, Any]:
        """Throughput, queue depth, page-pool residency, bucket counts
        (plus the tenant and its live allowance under an arbiter)."""
        p = self._metrics_prefix()
        snap = self.metrics().snapshot(p + "/")
        out: Dict[str, Any] = {k: snap[f"{p}/{k}"] for k in self._STATS_KEYS}
        out["kv"] = self.kv.residency()
        out["transport"] = self.transport.stats()
        if self.arbiter is not None:
            out["tenant"] = snap[f"{p}/tenant"]
            out["allowance"] = snap[f"{p}/allowance"]
        return out
