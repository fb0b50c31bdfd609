"""repro_torch.obs — the modeled-clock flight recorder, metrics registry,
Chrome/Perfetto export and per-link utilization report the serving
engine, the pool scheduler and colocation report through."""

from repro_torch.obs.export import (format_link_report, link_report,
                                    link_report_from_trace, link_tier,
                                    tier_report, to_chrome_trace,
                                    validate_trace_events,
                                    write_chrome_trace)
from repro_torch.obs.metrics import Gauge, MetricsRegistry
from repro_torch.obs.trace import (CAT_ARBITER, CAT_ENGINE, CAT_FABRIC,
                                   CAT_KV, CAT_LINK, CAT_REQUEST, CAT_SCHED,
                                   NULL_TRACER, Event, NullTracer, Tracer,
                                   resolve)

__all__ = [
    "CAT_ARBITER", "CAT_ENGINE", "CAT_FABRIC", "CAT_KV", "CAT_LINK",
    "CAT_REQUEST", "CAT_SCHED", "Event", "Gauge", "MetricsRegistry",
    "NULL_TRACER", "NullTracer", "Tracer", "format_link_report",
    "link_report", "link_report_from_trace", "link_tier", "resolve",
    "tier_report", "to_chrome_trace", "validate_trace_events",
    "write_chrome_trace",
]
