"""repro_torch.disagg — disaggregated prefill/decode serving over the routed
XLink-CXL fabric (paper §6: composable resource disaggregation); the
port of ``repro.disagg``, the same modules on the port's engine.

The package binds one multi-pod lease into two tiers:

- ``prefill`` (``PrefillWorker``): bucketed prefill on prefill-pod
  engines, exporting KV page-by-page at modeled prefill-progress times
  through the colocated engine's own admission prefill — bit-identical
  first tokens and page payloads.
- ``decode``: the receive side is the existing ``serve.Engine`` through
  its ``submit_prefilled`` seam — admission gated on KV arrival,
  partial-arrival slot occupancy, first decode gated on the last page.
- ``router`` (``DisaggCluster``, ``DisaggConfig``): per-request
  dispatch (prefill-queue depth + predicted transit vs a colocated
  fallback) on one modeled clock, streaming pages over the shared
  ``fabric.Transport`` as ``kv:<tenant>`` flows, either direct
  pod-to-pod or staged through a tier-2 memory node.

A degenerate cluster (``route=None``) replays the plain colocated
``Engine`` bit-for-bit — tokens *and* trace events — which is the
subsystem's correctness anchor: disaggregation moves *when* decode may
start, never *what* it computes.

On a lease's (pod, data, model) grid (a world of as many ranks, one
process each) every rank holds both tiers on one grid, the engines
from the members of one ``ResourcePool.lease_gang``
(``Engine.from_lease(..., grid=)``): a rank's exported pages hold its
kv heads (the same on every data replica) and land in its own decode
pool, its ``Transport`` prices the whole model's pages, and every rank
keeps the reference's clocks.
"""

from repro_torch.disagg.decode import decode_load, pick_decode_engine
from repro_torch.disagg.prefill import PrefillRecord, PrefillWorker
from repro_torch.disagg.router import DisaggCluster, DisaggConfig

__all__ = [
    "DisaggCluster",
    "DisaggConfig",
    "PrefillRecord",
    "PrefillWorker",
    "decode_load",
    "pick_decode_engine",
]
