"""Per-job routed collective phases over a shared ``fabric.Transport``.

``core.simulator.simulate_step`` prices a training step with closed-form
collective algebra on whole-fabric ``FabricSpec``s.  Co-residency needs
the fabric-crossing slices of that step to be *visible* on the estate
graph: registered as in-flight transfers so they max-min share links
with serving spill/fetch traffic (and other jobs' collectives), and so
their link occupancy shows up in ``obs.link_report`` under the job's
label.

The decomposition keeps the legacy step time as the uncontended base
and adds only the *contention stretch* the transport observes
(``core.costmodel.routed_phase_time``): a solo job's routed step is
bit-identical to ``simulate_step(...).total``, because the stretch
compares the transport's duration against the identical float
expression its solo fast path evaluates.  The registered volume per
phase is chosen so the phase occupies its route for exactly its base
duration at the route's bottleneck bandwidth
(``core.costmodel.phase_volume``) — attribution is scale-invariant in
the estate's absolute link capacities.

Phase-to-route mapping for a placed job (gateway = lowest pod id):

    pp       — gateway pod -> next pod (stage boundary traffic)
    dp       — gateway pod -> farthest pod (inter-group gradient phase)
    offload  — gateway pod -> tier-2 memory node (optimizer shuttle)

Phases whose closed-form base fits inside the route latency register
nothing (there is no meaningful payload to serialize).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from repro_torch.core import costmodel as cm
from repro_torch.core.simulator import StepBreakdown
from repro_torch.fabric.topology import Route, Topology

# step phases that cross the inter fabric, in intra-step order: the
# StepBreakdown field carrying each phase's closed-form base seconds
_PHASE_FIELDS = (("pp", "comm_pp"), ("dp", "comm_dp_exposed"),
                 ("offload", "offload"))


@dataclass(frozen=True)
class CollectivePhase:
    """One fabric-crossing slice of a training step, pinned to a route."""
    name: str          # "pp" | "dp" | "offload"
    base_s: float      # legacy closed-form seconds (uncontended)
    route: Route
    volume: float      # payload bytes registered on the transport


def job_routes(topo: Topology, pods: Sequence[int],
               mem_nodes: Sequence[int] = ()) -> Dict[str, Route]:
    """Pin a placed job's collective routes on the estate graph: the
    gang's gateway (lowest pod id) anchors the PP boundary to its
    nearest peer, the DP inter-group phase to its farthest peer, and
    the offload shuttle to the job's first tier-2 node."""
    pods = sorted(set(pods))
    routes: Dict[str, Route] = {}
    if len(pods) > 1:
        gw = f"pod:{pods[0]}"
        routes["pp"] = topo.route(gw, f"pod:{pods[1]}")
        routes["dp"] = topo.route(gw, f"pod:{pods[-1]}")
    if mem_nodes:
        routes["offload"] = topo.route(f"pod:{pods[0]}",
                                       f"mem:{sorted(mem_nodes)[0]}")
    return routes


def plan_phases(bd: StepBreakdown,
                routes: Dict[str, Route]) -> Tuple[CollectivePhase, ...]:
    """The fabric-crossing phases of one step that actually carry
    payload on this job's routes, in intra-step order."""
    phases: List[CollectivePhase] = []
    for name, fld in _PHASE_FIELDS:
        base = getattr(bd, fld)
        route = routes.get(name)
        if base <= 0.0 or route is None:
            continue
        vol = cm.phase_volume(base, route)
        if vol <= 0.0:
            continue
        phases.append(CollectivePhase(name, base, route, vol))
    return tuple(phases)


@dataclass
class TrainActor:
    """A training job as a co-residency event source: every ``step()``
    prices one training step at the actor's clock, registering each
    fabric-crossing phase on the shared transport (labeled
    ``train:<name>``) and absorbing whatever contention stretch the
    in-flight serving/collective traffic inflicts.  Drop-in peer of a
    serving ``Engine`` for ``colo.driver.run_colo``: exposes ``clock``,
    ``idle``, ``step() -> dt``, ``advance_clock``."""
    name: str
    breakdown: StepBreakdown
    transport: object                    # fabric.Transport (duck-typed)
    routes: Dict[str, Route]
    n_steps: int
    clock: float = 0.0
    steps_done: int = 0
    stretch_s: float = 0.0               # contention-induced excess
    step_times: List[float] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.phases = plan_phases(self.breakdown, self.routes)
        self._label = f"train:{self.name}"

    @property
    def idle(self) -> bool:
        return self.steps_done >= self.n_steps

    def advance_clock(self, t: float) -> None:
        self.clock = max(self.clock, t)

    def step(self) -> float:
        """One training step at the actor's clock.  Returns modeled
        seconds: the closed-form step time plus the contention stretch
        of each routed phase (0.0 exactly when the fabric is quiet).

        The fabric phases are priced at the *head* of the step window
        (the non-fabric compute/TP/bubble remainder follows them): the
        driver schedules the actor when its clock is the estate's
        minimum, so begin times at the head land among the serving
        flows its peers have in flight — pricing at the tail would date
        every begin past traffic the co-resident engines already
        charged into their own clocks, and the step would never observe
        the contention it causes."""
        t = self.clock
        dt = self.breakdown.total
        for p in self.phases:
            phase_s = cm.routed_phase_time(self.transport, p.route,
                                           p.base_s, t, label=self._label)
            stretch = phase_s - p.base_s
            dt += stretch
            self.stretch_s += stretch
            t += phase_s
        self.clock += dt
        self.steps_done += 1
        self.step_times.append(dt)
        return dt

    # ---- observability ---------------------------------------------------
    def stats(self) -> Dict[str, float]:
        done = max(1, self.steps_done)
        return {
            "steps": self.steps_done,
            "clock_s": self.clock,
            "step_s_avg": sum(self.step_times) / done,
            "step_s_max": max(self.step_times, default=0.0),
            "base_step_s": self.breakdown.total,
            "stretch_s": self.stretch_s,
            "phases": {p.name: {"base_s": p.base_s, "bytes": p.volume,
                                "route": f"{p.route.src}->{p.route.dst}"}
                       for p in self.phases},
        }
