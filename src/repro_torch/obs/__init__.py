"""repro_torch.obs — the modeled-clock flight recorder, metrics registry
and Chrome/Perfetto export the serving engine reports through."""

from repro_torch.obs.export import (link_tier, to_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.metrics import Gauge, MetricsRegistry
from repro_torch.obs.trace import (CAT_ENGINE, CAT_FABRIC, CAT_KV, CAT_LINK,
                                   CAT_REQUEST, NULL_TRACER, Event,
                                   NullTracer, Tracer, resolve)

__all__ = [
    "CAT_ENGINE", "CAT_FABRIC", "CAT_KV", "CAT_LINK", "CAT_REQUEST",
    "Event", "Gauge", "MetricsRegistry",
    "NULL_TRACER", "NullTracer", "Tracer", "link_tier", "resolve",
    "to_chrome_trace", "write_chrome_trace",
]
