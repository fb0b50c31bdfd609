"""repro_torch.serve — the request-level serving engine of the port.

    api    — Request / RequestHandle / EngineConfig / ServeCostModel
    engine — Engine: continuous batching over a budgeted, paged KV pool
    trace  — arrival traces and the trace -> engine driver

Quickstart::

    from repro_torch.models.api import build_model
    from repro_torch.serve import Engine, EngineConfig, Request
    model = build_model(cfg)                     # on the card
    eng = Engine.local(model, EngineConfig(max_slots=4, max_seq=128))
    h = eng.submit(Request(prompt_tokens=(1, 2, 3), max_new_tokens=8))
    eng.run_until_idle()
    print(h.result(), eng.stats())
"""

from repro_torch.core.tiering import KVBudget, KVBudgetExceeded, PagedKV
from repro_torch.serve.api import (EngineConfig, Request, RequestHandle,
                                   RequestStatus, ServeCostModel)
from repro_torch.serve.engine import Engine, slice_page
from repro_torch.serve.trace import (burst_trace, latency_summary,
                                     load_trace, run_trace, synthetic_trace)

__all__ = [
    "Engine", "EngineConfig", "KVBudget", "KVBudgetExceeded", "PagedKV",
    "Request", "RequestHandle", "RequestStatus", "ServeCostModel",
    "burst_trace", "latency_summary", "load_trace", "run_trace",
    "slice_page", "synthetic_trace",
]
