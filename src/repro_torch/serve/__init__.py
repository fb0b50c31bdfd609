"""repro_torch.serve — the request-level serving engine of the port.

    api     — Request / RequestHandle / EngineConfig / ServeCostModel
    engine  — Engine: continuous batching over a budgeted, paged KV pool
    arbiter — PoolArbiter: N tenant engines share ONE physical page
              pool under revocable max-min fair shares
    trace   — arrival traces, the trace -> engine driver and the
              clock-interleaved multi-tenant driver

Quickstart::

    from repro_torch.models.api import build_model
    from repro_torch.serve import Engine, EngineConfig, Request
    model = build_model(cfg)                     # on the card
    eng = Engine.local(model, EngineConfig(max_slots=4, max_seq=128))
    h = eng.submit(Request(prompt_tokens=(1, 2, 3), max_new_tokens=8))
    eng.run_until_idle()
    print(h.result(), eng.stats())

Multi-tenant (N engines drawing on ONE shared page pool)::

    arb = PoolArbiter(tier1_pages=24, page_size=16)
    a = Engine.local(model, cfg, arbiter=arb, tenant="a")
    b = Engine.local(model, cfg, arbiter=arb, tenant="b")
    run_multi_trace([(a, trace_a), (b, trace_b)])

Lease-backed (the orchestrator composes the KV budget)::

    lease = smoke_pool().lease("svc", 4, tier2_gb=8, kv_gb=2)
    eng = Engine.from_lease(model, lease, EngineConfig(max_slots=8))
"""

from repro_torch.core.tiering import KVBudget, KVBudgetExceeded, PagedKV
from repro_torch.serve.api import (EngineConfig, Request, RequestHandle,
                                   RequestStatus, ServeCostModel)
from repro_torch.serve.arbiter import PoolArbiter
from repro_torch.serve.engine import Engine, slice_page
from repro_torch.serve.trace import (burst_trace, latency_summary,
                                     load_trace, run_multi_trace, run_trace,
                                     synthetic_trace)

__all__ = [
    "Engine", "EngineConfig", "KVBudget", "KVBudgetExceeded", "PagedKV",
    "PoolArbiter", "Request", "RequestHandle", "RequestStatus",
    "ServeCostModel", "burst_trace", "latency_summary", "load_trace",
    "run_multi_trace", "run_trace", "slice_page", "synthetic_trace",
]
