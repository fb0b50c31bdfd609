"""repro_torch.colo — train+serve co-residency on one contended estate.

The paper's headline claims are about LLM *training* on the unified
XLink-CXL fabric, yet training collectives priced on a whole-fabric
``core.fabric.FabricSpec`` are invisible to the ``fabric.Transport``
that serving spill/fetch traffic rides — the two workload classes can
never contend for the same links.  This package closes that gap:

    collectives — per-job routed collective phases: each training
        job's fabric-crossing phases (PP boundary, exposed DP
        gradient, optimizer offload) become in-flight transfers on
        the shared ``Transport``, max-min sharing links with serving
        traffic, with the closed-form ``core.simulator`` time as the
        uncontended base (bit-exact when solo);
    driver      — a clock-interleaved co-residency driver advancing
        training step events and ``run_multi_trace`` serving engines
        on one shared modeled clock and one shared ``Transport``.

Contention-aware *placement* for co-resident jobs lives in
``repro_torch.pool.allocator`` (``policy="contention"``).
"""

from repro_torch.colo.collectives import (CollectivePhase, TrainActor,
                                          job_routes, plan_phases)
from repro_torch.colo.driver import ColoResult, run_colo

__all__ = ["CollectivePhase", "ColoResult", "TrainActor", "job_routes",
           "plan_phases", "run_colo"]
