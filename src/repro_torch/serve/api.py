"""Request-level serving API types (paper §6, Fig. 7 at request granularity).

A ``Request`` is what a client submits; a ``RequestHandle`` is the
engine's live view of it (status, generated tokens, latency clocks).
``EngineConfig`` sizes the slot array and page geometry; ``ServeCostModel``
prices engine events in *modeled* seconds from the paper's fabric
constants, so latency sweeps are hardware-derived rather than CPU-smoke
wall-clock noise.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Tuple

from repro_torch.core import fabric as fb

GB = 1e9


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    SWAPPED = "swapped"        # descheduled under page pressure; its KV
                               # pages are evictable (coldest-first) to
                               # the tier-2 capacity pool
    DONE = "done"
    FAILED_OOM = "failed_oom"  # can never fit the tier-1 page quota


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: a prompt plus a decode budget."""

    prompt_tokens: Tuple[int, ...]
    max_new_tokens: int
    arrival_time: float = 0.0          # modeled seconds (trace-driven)

    def __post_init__(self):
        object.__setattr__(self, "prompt_tokens",
                           tuple(int(t) for t in self.prompt_tokens))
        if len(self.prompt_tokens) == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)


@dataclasses.dataclass
class RequestHandle:
    """Live engine-side state of a submitted request."""

    rid: int
    request: Request
    status: RequestStatus = RequestStatus.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_clock: float = 0.0
    first_token_clock: Optional[float] = None
    done_clock: Optional[float] = None
    preempts: int = 0                  # descheduled under page pressure
                                       # (costless until pages actually move)
    swaps: int = 0                     # tier-2 spill episodes: batches of
                                       # this request's pages that really
                                       # rode the capacity fabric
    recomputes: int = 0                # KV dropped + re-prefilled (no
                                       # tier-2 headroom to spill into)
    kv_transit_s: float = 0.0          # modeled seconds this request's KV
                                       # pages spent in flight on the fabric
                                       # (disaggregated prefill->decode
                                       # handoff; 0.0 when colocated)

    @property
    def done(self) -> bool:
        return self.status in (RequestStatus.DONE, RequestStatus.FAILED_OOM)

    @property
    def latency(self) -> Optional[float]:
        return (None if self.done_clock is None
                else self.done_clock - self.submit_clock)

    @property
    def ttft(self) -> Optional[float]:
        return (None if self.first_token_clock is None
                else self.first_token_clock - self.submit_clock)

    def result(self) -> List[int]:
        if self.status is RequestStatus.FAILED_OOM:
            raise RuntimeError(f"request {self.rid} failed: tier-1 KV quota "
                               f"cannot ever hold it")
        if not self.done:
            raise RuntimeError(f"request {self.rid} still {self.status.value}")
        return list(self.tokens)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Slot-array and page geometry of the engine."""

    max_slots: int = 4                 # concurrent decode slots
    max_seq: int = 256                 # per-slot KV capacity (tokens)
    page_size: int = 64                # tokens per KV page
    cache_dtype: Any = "float32"       # dtype name or torch dtype
    eos_token: Optional[int] = None    # early stop (None = run to budget)
    # classic tier-1-only serving: reserve a request's full-lifetime KV at
    # admission (no growth, no preemption risk).  Safe without a spill
    # target, but concurrency collapses to quota // lifetime_pages — the
    # static alternative optimistic paging + tier-2 swap relieves.
    reserve_lifetime: bool = False

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_size)


@dataclasses.dataclass(frozen=True)
class ServeCostModel:
    """Modeled event costs (seconds).  Defaults derive from the paper's
    hardware constants: decode steps are weight-read bound on HBM, swap
    traffic rides the capacity-oriented CXL fabric (§5).

    Transfer pricing note: the tier-2 constants here are a *facade*
    over a degenerate 1-link ``repro_torch.fabric`` route — ``transport()``
    builds the equivalent ``Transport``, and a solo transfer on it
    costs exactly ``swap_s(nbytes)``.  Engines charge spill/fetch
    through a transport, so several consumers of one fabric genuinely
    contend; an engine constructed without an explicit
    ``transport=``/``route=`` gets a private degenerate one from this
    model and reproduces the legacy numbers bit-exactly.
    """

    prefill_s_per_token: float = 2e-5
    decode_s_per_step: float = 2e-3    # batched step, weight-bound floor
    decode_s_per_token: float = 5e-5   # marginal per resident sequence
    tier2_bw: float = 0.0              # bytes/s, 0 = derive from fabric
    tier2_lat: float = 0.0             # per-transfer setup latency

    @staticmethod
    def from_fabric(n_param_bytes: float,
                    hbm_bw: float = 8000.0 * GB,
                    tier2: Optional[fb.FabricSpec] = None) -> "ServeCostModel":
        """DEPRECATED (kept working): collapses the whole tier-2 fabric
        into two scalars, so every consumer prices as if it had the
        fabric to itself.  Migration: keep the compute-side constants,
        but share one ``repro_torch.fabric.Transport`` across consumers —
        build ``Topology.from_inventory(pool_inventory)`` (or any
        explicit graph), take per-consumer ``topology.route(...)``s,
        and pass ``Engine(..., transport=, route=)`` so concurrent
        transfers fair-share the actual links."""
        t2 = tier2 or fb.tier2_memory_fabric(8)
        return ServeCostModel(
            prefill_s_per_token=max(1e-6, n_param_bytes / hbm_bw / 8),
            decode_s_per_step=max(1e-5, n_param_bytes / hbm_bw),
            decode_s_per_token=max(1e-6, n_param_bytes / hbm_bw / 32),
            tier2_bw=t2.bandwidth() * GB,
            tier2_lat=t2.latency())

    def resolved_tier2_bw(self) -> float:
        """The swap bandwidth actually priced (bytes/s)."""
        return self.tier2_bw or fb.tier2_memory_fabric(8).bandwidth() * GB

    def degenerate_topology(self):
        """The 1-link ``repro_torch.fabric.Topology`` equivalent to this
        model's tier-2 scalars (route ``"src" -> "dst"``)."""
        from repro_torch.fabric import Topology
        return Topology.degenerate(self.resolved_tier2_bw(), self.tier2_lat,
                                   name="ServeCostModel[tier2]")

    def transport(self):
        """A private ``Transport`` over ``degenerate_topology()`` — the
        facade engines fall back to when no shared fabric is passed."""
        from repro_torch.fabric import Transport
        return Transport(self.degenerate_topology())

    def swap_s(self, nbytes: float) -> float:
        """Solo transfer seconds on the degenerate route (legacy name).
        A transport-routed transfer with no concurrent flows returns
        this exact float."""
        return self.tier2_lat + nbytes / self.resolved_tier2_bw()

    def prefill_s(self, n_tokens: int) -> float:
        return self.prefill_s_per_token * n_tokens

    def decode_s(self, n_resident: int) -> float:
        return self.decode_s_per_step + self.decode_s_per_token * n_resident
