"""Discrete-event multi-job scheduler over the composable pool.

Jobs are LLM training runs described by the same ``LLMConfig`` /
``ParallelismConfig`` pairs the §6 simulator uses; a job's execution rate
comes from ``core.simulator.simulate_step`` under the pool's interconnect
(``baseline`` IB vs ``scalepool`` CXL), so every second of simulated time
is derived from the paper's cost models — the scheduler adds only
*when* jobs run and *where* they are placed.

Mechanics: submit → FIFO queue (+ backfill) → admit via the topology-
aware allocator → finish.  Higher-priority head-of-line jobs may preempt
(newest, lowest-priority victims first, requeued with their remaining
steps); elastic jobs admit shrunk (dp halved until they fit) and grow
back toward their full data-parallel width when resources free up.

``Scheduler(queueing="drf")`` replaces FIFO+backfill with dominant-
resource fairness over ⟨accels, tier-2 bytes, tier-2 bandwidth⟩: each
admission round offers resources to the user with the smallest dominant
share, and jobs naming the same ``gang`` admit all-or-nothing (a
partially-placed gang would strand resources waiting for its peers).

Gangs may be declared with ``PoolJob.gang_size``: members submitted at
*different* timestamps are held in a pending-gang buffer until the
gang is complete, then queued together and admitted atomically (in
both queueing modes) — an early member can never admit alone.  Tier-2
bandwidth demands are admitted by the allocator against the routed
estate graph's link capacities (``repro_torch.fabric``), so the shared
capacity-fabric trunk caps the aggregate, not just per-node scalars.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import tiebreak
from repro_torch.core import simulator as sim
from repro_torch.obs.trace import CAT_SCHED, resolve
from repro_torch.pool.allocator import Allocation, Allocator, JobRequest
from repro_torch.pool.inventory import Inventory


@dataclass(frozen=True)
class PoolJob:
    """One training job submitted to the pool."""

    name: str
    model: sim.LLMConfig
    par: sim.ParallelismConfig
    n_steps: int
    tier2_bytes: float = 0.0
    tier2_bw: float = 0.0         # capacity-fabric bandwidth demand, bytes/s
    submit_t: float = 0.0
    priority: int = 0
    elastic: bool = False
    min_dp: int = 1
    # DRF queueing (Scheduler(queueing="drf")): jobs of one ``user``
    # share a dominant-resource fairness account; jobs naming the same
    # ``gang`` are co-scheduled all-or-nothing (submit them together).
    user: str = ""
    gang: str = ""
    # declared gang width: members submitted at *different* timestamps
    # are held in the scheduler's pending-gang buffer until this many
    # have arrived, then queued (and admitted) together.  0 = undeclared
    # (legacy: whatever is queued at one timestamp is the gang).
    gang_size: int = 0

    @property
    def n_accels(self) -> int:
        return self.par.n_gpus

    @property
    def drf_user(self) -> str:
        return self.user or self.name

    @property
    def gang_key(self) -> Tuple[str, str]:
        # RAW user, not drf_user: the drf fallback (user or name) would
        # scatter a no-user gang's members across per-job keys and hold
        # each "1/N-member gang" forever.  A gang belongs to one user;
        # all-unset is one user too.
        return (self.user, self.gang)


def offload_bytes(model: sim.LLMConfig,
                  calib: sim.Calibration) -> float:
    """Capacity-tier demand of an offloaded optimizer for ``model`` —
    the same constant the §6 step simulator charges per step."""
    return calib.optimizer_bytes_per_param * model.n_params


def offload_bw(model: sim.LLMConfig, calib: sim.Calibration,
               steps_per_sec: float) -> float:
    """Sustained capacity-fabric bandwidth (bytes/s) an offloaded
    optimizer streams: moments read + written back every step.  Feed
    this into ``PoolJob.tier2_bw`` so concurrent offload-heavy jobs
    contend on tier-2 bandwidth, not just bytes."""
    return 2.0 * offload_bytes(model, calib) * steps_per_sec


@dataclass
class JobRecord:
    """Per-job outcome of a schedule."""

    name: str
    submit_t: float
    start_t: Optional[float] = None     # first admission
    finish_t: Optional[float] = None
    preemptions: int = 0
    resizes: int = 0
    dp_granted: int = 0                 # dp at final admission
    accel_seconds: float = 0.0          # busy integral

    @property
    def jct(self) -> Optional[float]:
        return None if self.finish_t is None else self.finish_t - self.submit_t

    @property
    def queue_delay(self) -> Optional[float]:
        return None if self.start_t is None else self.start_t - self.submit_t


@dataclass
class _Running:
    job: PoolJob
    par: sim.ParallelismConfig          # possibly shrunk
    alloc: Allocation
    step_time: float
    steps_done: float
    seg_start: float                    # start of the current segment
    epoch: int                          # invalidates stale finish events


@dataclass
class ScheduleResult:
    records: Dict[str, JobRecord]
    trace: List[str]                    # deterministic event log
    makespan: float
    util_area: float                    # busy accel-seconds
    granted_area: float                 # held accel-seconds
    frag_samples: List[float]
    total_accels: int

    @property
    def utilization(self) -> float:
        denom = self.total_accels * self.makespan
        return self.util_area / denom if denom > 0 else 0.0

    @property
    def stranded_frac(self) -> float:
        denom = self.total_accels * self.makespan
        return (self.granted_area - self.util_area) / denom if denom > 0 else 0.0

    @property
    def mean_jct(self) -> float:
        jcts = [r.jct for r in self.records.values() if r.jct is not None]  # repro: allow(no-unordered-iteration) records insert in submit() call order — spec'd, not incidental
        return sum(jcts) / len(jcts) if jcts else 0.0

    @property
    def mean_queue_delay(self) -> float:
        qs = [r.queue_delay for r in self.records.values()  # repro: allow(no-unordered-iteration) records insert in submit() call order — spec'd, not incidental
              if r.queue_delay is not None]
        return sum(qs) / len(qs) if qs else 0.0

    @property
    def mean_fragmentation(self) -> float:
        return (sum(self.frag_samples) / len(self.frag_samples)
                if self.frag_samples else 0.0)

    def summary(self) -> Dict[str, float]:
        return dict(utilization=self.utilization,
                    stranded_frac=self.stranded_frac,
                    mean_jct=self.mean_jct,
                    mean_queue_delay=self.mean_queue_delay,
                    mean_fragmentation=self.mean_fragmentation,
                    makespan=self.makespan,
                    n_finished=sum(r.finish_t is not None
                                   for r in self.records.values()))  # repro: allow(no-unordered-iteration) integer count — exact and commutative in any order


class Scheduler:
    """Event-driven scheduler; fully deterministic for a fixed job list."""

    _TRACK = "pool:sched"

    def __init__(self, inventory: Inventory, policy: Optional[str] = None,
                 *, backfill: bool = True,
                 calib: Optional[sim.Calibration] = None,
                 queueing: str = "fifo", tracer=None):
        if queueing not in ("fifo", "drf"):
            raise ValueError(f"unknown queueing policy {queueing!r} "
                             f"(expected 'fifo' or 'drf')")
        self.tracer = resolve(tracer)
        self.inv = inventory
        self.alloc = Allocator(inventory, policy)
        self.policy = self.alloc.policy
        self.backfill = backfill
        self.queueing = queueing
        self.calib = calib or dataclasses.replace(
            sim.Calibration(), cluster_size=inventory.pod_size)
        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self._queue: List[PoolJob] = []
        # partial gangs (gang_size declared, not all members arrived):
        # held OUT of the admission queue so an early member can never
        # admit alone — all-or-nothing needs the whole gang visible
        self._pending_gangs: Dict[Tuple[str, str], List[PoolJob]] = {}
        self._running: Dict[str, _Running] = {}
        self.records: Dict[str, JobRecord] = {}
        self.trace: List[str] = []
        self._now = 0.0
        self._last_t = 0.0
        self._util_area = 0.0
        self._granted_area = 0.0
        self._frag_samples: List[float] = []
        self._step_cache: Dict[Tuple, float] = {}
        self._geom_emitted = False

    # ---- public API ------------------------------------------------------
    def submit(self, job: PoolJob) -> None:
        self._push(job.submit_t, "submit", job)
        self.records[job.name] = JobRecord(job.name, job.submit_t)

    def run(self, until: float = math.inf) -> ScheduleResult:
        if self.tracer.enabled and not self._geom_emitted:
            # pool geometry, once: the conservation baseline the
            # repro_torch.analysis sanitizer checks accel counters against
            self._geom_emitted = True
            self.tracer.instant(self._TRACK, "sched_pool", self._now,
                                cat=CAT_SCHED,
                                accels=self.inv.total_accels)
        while self._events:
            if self._events[0][0] > until:
                break   # leave the event for a later run() call
            t, seq, kind, data = heapq.heappop(self._events)
            self._advance(t)
            # drain every event sharing this timestamp BEFORE admitting:
            # co-submitted jobs (a DRF gang in particular) must be
            # visible to one admission round together, or the first
            # member admits alone and all-or-nothing is vacuous
            batch = [(seq, kind, data)]
            while self._events and self._events[0][0] == t:  # repro: allow(no-float-equality) heap keys are stored floats compared by identity — equality DEFINES the same-timestamp batch
                _, seq, kind, data = heapq.heappop(self._events)
                batch.append((seq, kind, data))
            # canonical handling order for one timestamp: submits FIFO
            # by submission sequence (spec), then finishes by sequence.
            # Heap pop order within a timestamp is thereby provably
            # irrelevant — the racecheck seam permutes the batch and the
            # sort restores the canonical order bit-exactly
            for _, kind, data in sorted(tiebreak.order(batch),
                                        key=lambda e: (e[1] != "submit",
                                                       e[0])):
                self._handle(kind, data)
            self._admit_and_grow()
        # partial horizon: accrue the tail window [last_event, until) —
        # without this, util_area/granted_area/makespan stop at the last
        # *processed* event and utilization over the horizon is overstated
        # (jobs straddling ``until`` contribute nothing past it).  With
        # work left (pending events or running jobs) the horizon is
        # ``until``; an already-drained schedule keeps its natural end.
        if math.isfinite(until) and (self._events or self._running):
            self._advance(until)
        for (user, gang), buf in sorted(self._pending_gangs.items()):
            want = max(j.gang_size for j in buf)
            self._log(f"WARNING gang {gang!r} incomplete at end of run: "
                      f"{len(buf)}/{want} members held, never admitted")
        return ScheduleResult(
            records=self.records, trace=self.trace, makespan=self._now,
            util_area=self._util_area, granted_area=self._granted_area,
            frag_samples=self._frag_samples,
            total_accels=self.inv.total_accels)

    # ---- internals -------------------------------------------------------
    def _handle(self, kind: str, data) -> None:
        if kind == "submit":
            self._log(f"submit {data.name} "
                      f"(n={data.n_accels}, t2={data.tier2_bytes/1e9:.0f}GB)")
            if self.tracer.enabled:
                self.tracer.instant(self._TRACK, "submit", self._now,
                                    cat=CAT_SCHED, job=data.name,
                                    accels=data.n_accels,
                                    tier2_bytes=data.tier2_bytes)
            if data.gang:
                held = self._pending_gangs.get(data.gang_key)
                if held is not None and data.gang_size != held[0].gang_size:
                    # a mixed declaration either splits the gang (an
                    # undeclared member admits alone) or strands it (a
                    # too-big size never completes) — both silently
                    raise ValueError(
                        f"{data.name}: gang {data.gang!r} declared with "
                        f"gang_size={held[0].gang_size} but this member "
                        f"says {data.gang_size} — every member of a "
                        f"gang must declare the same size")
            if data.gang and data.gang_size > 1:
                buf = self._pending_gangs.setdefault(data.gang_key, [])
                buf.append(data)
                want = buf[0].gang_size
                if len(buf) < want:
                    self._log(f"hold {data.name} "
                              f"(gang {data.gang!r} {len(buf)}/{want})")
                    if self.tracer.enabled:
                        self.tracer.instant(self._TRACK, "hold", self._now,
                                            cat=CAT_SCHED, job=data.name,
                                            gang=data.gang,
                                            arrived=len(buf), want=want)
                    return
                del self._pending_gangs[data.gang_key]
                self._queue.extend(buf)
                self._log(f"gang {data.gang!r} complete "
                          f"({len(buf)} jobs) -> queue")
                if self.tracer.enabled:
                    self.tracer.instant(self._TRACK, "gang_complete",
                                        self._now, cat=CAT_SCHED,
                                        gang=data.gang, members=len(buf))
                return
            self._queue.append(data)
        elif kind == "finish":
            name, epoch = data
            run = self._running.get(name)
            if run is None or run.epoch != epoch:
                return      # stale: job was preempted/resized
            self._finish(run)

    def _push(self, t: float, kind: str, data) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, kind, data))

    def _log(self, msg: str) -> None:
        self.trace.append(f"t={self._now:.2f} {msg}")

    def _advance(self, t: float) -> None:
        dt = t - self._last_t
        if dt > 0:
            busy = sum(r.alloc.n_requested for r in self._running.values())  # repro: allow(no-unordered-iteration) integer sum — exact and commutative in any order
            granted = sum(r.alloc.n_granted for r in self._running.values())  # repro: allow(no-unordered-iteration) integer sum — exact and commutative in any order
            self._util_area += busy * dt
            self._granted_area += granted * dt
            self._last_t = t
        self._now = t

    def step_time(self, job: PoolJob, par: sim.ParallelismConfig,
                  alloc: Allocation) -> float:
        """Seconds per training step under the pool's interconnect, from
        the §6 cost models.  The inter-cluster fabric a job sees is sized
        to its own placement span (a 1-pod job never pays multi-level
        CXL/IB switching; a wide job does)."""
        span_endpoints = max(self.inv.pod_size,
                             alloc.n_pods * self.inv.pod_size)
        offloads = job.tier2_bytes > 0
        # contention-aware placement changes WHERE a gang lands, not the
        # fabric it trains over: step costs price on the scalepool system
        sys_kind = "scalepool" if self.policy == "contention" else self.policy
        key = (job.model.name, par.tp, par.pp, par.dp,
               par.global_batch_seqs, par.microbatch_seqs, par.vpp,
               sys_kind, span_endpoints, offloads)
        if key not in self._step_cache:
            system = sim.make_system(sys_kind, span_endpoints, self.calib)
            bd = sim.simulate_step(job.model, par, system)
            # jobs without a capacity reservation run no offload traffic;
            # charging them the (policy-dependent) offload path would leak
            # a difference that is not about resource composition.
            self._step_cache[key] = bd.total - (0.0 if offloads else bd.offload)
        return self._step_cache[key]

    # ---- admission -------------------------------------------------------
    def _request(self, job: PoolJob, par: sim.ParallelismConfig) -> JobRequest:
        return JobRequest(job.name, par.tp * par.pp * par.dp, job.tier2_bytes,
                          tier2_bw=job.tier2_bw)

    def _try_admit(self, job: PoolJob) -> bool:
        """Full size, then elastic shrink (dp halving) if allowed."""
        dp = job.par.dp
        while dp >= max(1, job.min_dp):
            par = dataclasses.replace(job.par, dp=dp)
            alloc = self.alloc.allocate(self._request(job, par))
            if alloc is not None:
                self._start(job, par, alloc)
                return True
            if not job.elastic or dp == job.min_dp:
                return False
            dp = max(job.min_dp, dp // 2)
        return False

    def _try_admit_with_preemption(self, job: PoolJob) -> bool:
        """Head-of-line high-priority admission: preempt newest lowest-
        priority victims until the job fits (all-or-nothing).  Members
        of a declared gang are not preemptable — yanking one would
        leave its peers running, breaking the gang's all-or-nothing
        placement (gang-wide preemption is a follow-up)."""
        victims = sorted(
            (r for r in self._running.values()
             if r.job.priority < job.priority
             and not (r.job.gang and r.job.gang_size > 1)),
            key=lambda r: (r.job.priority, -r.seg_start, r.job.name))
        if not victims:
            return False
        snapshot = self.alloc.snapshot()
        preempted: List[_Running] = []
        ok = False
        for v in victims:
            self._suspend(v)
            preempted.append(v)
            alloc = self.alloc.allocate(self._request(job, job.par))
            if alloc is not None:
                self._start(job, job.par, alloc)
                ok = True
                break
        if not ok:
            # restore: nobody should have been harmed
            self.alloc.restore(snapshot)
            for v in preempted:
                self._running[v.job.name] = v
            return False
        for v in preempted:
            rec = self.records[v.job.name]
            rec.preemptions += 1
            remaining = max(1, math.ceil(v.job.n_steps - v.steps_done))
            requeue = dataclasses.replace(v.job, n_steps=remaining,
                                          submit_t=self._now)
            self._queue.append(requeue)
            self._log(f"preempt {v.job.name} ({remaining} steps left) "
                      f"for {job.name}")
            if self.tracer.enabled:
                self.tracer.instant(self._TRACK, "preempt", self._now,
                                    cat=CAT_SCHED, job=v.job.name,
                                    by=job.name, steps_left=remaining)
        return True

    def _admit_and_grow(self) -> None:
        if self.queueing == "drf":
            self._admit_drf()
        else:
            self._admit_fifo()
        self._grow_elastic()
        if self.tracer.enabled:
            # accel conservation sample, once per admission round:
            # free + granted-to-running == pool total, checked by the
            # repro_torch.analysis sanitizer's sched-accel-conservation rule
            free = self.alloc.free_accels()
            busy = sum(r.alloc.n_granted for r in self._running.values())  # repro: allow(no-unordered-iteration) integer sum — exact and commutative in any order
            self.tracer.counter(self._TRACK, "free_accels", self._now,
                                float(free), cat=CAT_SCHED)
            self.tracer.counter(self._TRACK, "busy_accels", self._now,
                                float(busy), cat=CAT_SCHED)

    def _admit_fifo(self) -> None:
        # FIFO with optional backfill; preemption only for head-of-line.
        # Declared gangs (gang_size > 1) are one queue unit: admitted
        # via the all-or-nothing path or skipped whole.
        pending = self._gang_groups()
        self._queue = []            # preemption victims requeue here
        still_queued: List[PoolJob] = []
        head_blocked = False
        i = 0
        while i < len(pending):
            group = pending[i]
            i += 1
            if head_blocked and not self.backfill:
                still_queued.extend(group)
                continue
            if len(group) > 1:
                if self._try_admit_gang(group):
                    continue
            elif self._try_admit(group[0]):
                continue
            elif i == 1 and group[0].priority > 0 and \
                    self._try_admit_with_preemption(group[0]):
                # victims were requeued onto self._queue: give them the
                # same later-in-this-round shot the pre-group code did
                pending.extend([j] for j in self._queue)
                self._queue = []
                continue
            head_blocked = True
            still_queued.extend(group)
        self._queue = still_queued

    def _gang_groups(self) -> List[List[PoolJob]]:
        """Queue order preserved; jobs of one declared gang collapse
        into a single group at the first member's position."""
        groups: Dict[Tuple, List[PoolJob]] = {}
        order: List[Tuple] = []
        for job in self._queue:
            key = (job.gang_key if job.gang and job.gang_size > 1
                   else ("", job.name, id(job)))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(job)
        return [groups[k] for k in order]

    # ---- DRF queueing (gang-aware) ----------------------------------------
    def _dominant_share(self, user: str) -> float:
        """Dominant-resource share of ``user``'s running jobs over
        ⟨accels, tier-2 bytes, tier-2 bandwidth⟩ — the max across
        resource dimensions of demanded/total (Ghodsi et al.)."""
        caps = (self.inv.total_accels, self.inv.total_tier2,
                self.inv.total_tier2_bw)
        use = [0.0, 0.0, 0.0]
        # canonical (name-sorted) accumulation order: tier-2 bytes/bw
        # are float adds, and float addition is not associative — the
        # incidental insertion order of ``_running`` must never pick
        # which association the share gets
        for name in sorted(self._running):
            run = self._running[name]
            if run.job.drf_user != user:
                continue
            use[0] += run.alloc.n_requested
            use[1] += run.job.tier2_bytes
            use[2] += run.job.tier2_bw
        return max(u / c for u, c in zip(use, caps) if c > 0)

    def _try_admit_gang(self, jobs: List[PoolJob]) -> bool:
        """Admit every job of a gang or none of them: a partially-placed
        gang would hold resources while waiting for its peers — the
        all-or-nothing rule keeps the pool deadlock-free."""
        snapshot = self.alloc.snapshot()
        allocs = []
        for job in jobs:
            alloc = self.alloc.allocate(self._request(job, job.par))
            if alloc is None:
                self.alloc.restore(snapshot)
                return False
            allocs.append((job, alloc))
        for job, alloc in allocs:
            self._start(job, job.par, alloc, in_gang=len(jobs) > 1)
        if len(jobs) > 1:
            self._log(f"admit gang {jobs[0].gang!r} "
                      f"({len(jobs)} jobs, all-or-nothing)")
            if self.tracer.enabled:
                self.tracer.instant(self._TRACK, "gang_admit", self._now,
                                    cat=CAT_SCHED, gang=jobs[0].gang,
                                    members=len(jobs))
        return True

    def _admit_drf(self) -> None:
        """Dominant-resource-fair admission: repeatedly offer resources
        to the user with the smallest dominant share, admitting that
        user's oldest queued gang atomically.  Users whose head gang
        does not fit are skipped (work conservation: a later user's
        smaller gang may still be placed) — at full size only, no
        elastic shrink and no priority preemption in this mode."""
        while self._queue:
            gangs: Dict[Tuple[str, str], List[PoolJob]] = {}
            order: List[Tuple[str, str]] = []
            for job in self._queue:
                key = job.gang_key if job.gang else (job.drf_user, job.name)
                if key not in gangs:
                    gangs[key] = []
                    order.append(key)
                gangs[key].append(job)
            # gang identity keys on the raw user; fairness accounts stay
            # on drf_user (which falls back to the job name when unset)
            user_of = {k: gangs[k][0].drf_user for k in order}
            users = sorted({user_of[k] for k in order},
                           key=lambda u: (self._dominant_share(u), u))
            admitted = None
            for user in users:
                key = next(k for k in order if user_of[k] == user)
                if self._try_admit_gang(gangs[key]):
                    admitted = {id(j) for j in gangs[key]}
                    if self.tracer.enabled:
                        # post-admission dominant share of the user who
                        # just admitted — the sanitizer's
                        # sched-drf-share rule bounds it to [0, 1]
                        self.tracer.counter(
                            self._TRACK, f"drf_share:{user}", self._now,
                            self._dominant_share(user), cat=CAT_SCHED)
                    break
            if admitted is None:
                return
            self._queue = [j for j in self._queue if id(j) not in admitted]

    def _grow_elastic(self) -> None:
        """Double shrunk elastic jobs back toward full dp while it fits."""
        for name in sorted(self._running):
            run = self._running[name]
            if not run.job.elastic or run.par.dp >= run.job.par.dp:
                continue
            grew = False
            while run.par.dp < run.job.par.dp:
                new_dp = min(run.job.par.dp, run.par.dp * 2)
                new_par = dataclasses.replace(run.par, dp=new_dp)
                snapshot = self.alloc.snapshot()
                self.alloc.release(name)
                alloc = self.alloc.allocate(self._request(run.job, new_par))
                if alloc is None:
                    self.alloc.restore(snapshot)
                    break
                self._resize(run, new_par, alloc)
                grew = True
            if grew:
                self._log(f"grow {name} to dp={run.par.dp}")

    # ---- lifecycle -------------------------------------------------------
    def _start(self, job: PoolJob, par: sim.ParallelismConfig,
               alloc: Allocation, *, in_gang: bool = False) -> None:
        st = self.step_time(job, par, alloc)
        rec = self.records[job.name]
        if rec.start_t is None:
            rec.start_t = self._now
        rec.dp_granted = par.dp
        run = _Running(job, par, alloc, st, steps_done=0.0,
                       seg_start=self._now, epoch=rec.preemptions + rec.resizes)
        self._running[job.name] = run
        remaining = job.n_steps * st
        self._push(self._now + remaining, "finish", (job.name, run.epoch))
        self._frag_samples.append(self.alloc.metrics().fragmentation)
        self._log(f"admit {job.name} dp={par.dp} "
                  f"pods={list(alloc.pod_ids)} granted={alloc.n_granted} "
                  f"(stranded={alloc.n_stranded}) step={st*1e3:.1f}ms")
        if self.tracer.enabled:
            # ``gang`` is set ONLY for members co-admitted through the
            # all-or-nothing path: the sanitizer's sched-gang-atomic
            # rule requires every gang-tagged admit to be covered by a
            # same-timestamp gang_admit naming the full member count
            self.tracer.instant(self._TRACK, "admit", self._now,
                                cat=CAT_SCHED, job=job.name, dp=par.dp,
                                pods=list(alloc.pod_ids),
                                granted=alloc.n_granted,
                                stranded=alloc.n_stranded, step_s=st,
                                gang=job.gang if in_gang else "")

    def _account_segment(self, run: _Running) -> None:
        dt = self._now - run.seg_start
        if dt > 0:
            run.steps_done += dt / run.step_time
            self.records[run.job.name].accel_seconds += \
                run.alloc.n_requested * dt
            if self.tracer.enabled:
                # one span per contiguous execution segment: the job's
                # residency on the pool between admit/resize/preempt
                # boundaries, the rows a Perfetto "what ran when" view
                self.tracer.span(self._TRACK, f"run:{run.job.name}",
                                 run.seg_start, dt, cat=CAT_SCHED,
                                 job=run.job.name, dp=run.par.dp,
                                 accels=run.alloc.n_requested)
        run.seg_start = self._now

    def _suspend(self, run: _Running) -> None:
        self._account_segment(run)
        self.alloc.release(run.job.name)
        del self._running[run.job.name]

    def _resize(self, run: _Running, par: sim.ParallelismConfig,
                alloc: Allocation) -> None:
        self._account_segment(run)
        rec = self.records[run.job.name]
        rec.resizes += 1
        rec.dp_granted = par.dp
        run.par, run.alloc = par, alloc
        run.step_time = self.step_time(run.job, par, alloc)
        run.epoch += 1
        remaining = max(0.0, run.job.n_steps - run.steps_done) * run.step_time
        self._push(self._now + remaining, "finish",
                   (run.job.name, run.epoch))

    def _finish(self, run: _Running) -> None:
        self._account_segment(run)
        self.alloc.release(run.job.name)
        del self._running[run.job.name]
        rec = self.records[run.job.name]
        rec.finish_t = self._now
        self._frag_samples.append(self.alloc.metrics().fragmentation)
        self._log(f"finish {run.job.name} jct={rec.jct:.2f}s")
        if self.tracer.enabled:
            self.tracer.instant(self._TRACK, "finish", self._now,
                                cat=CAT_SCHED, job=run.job.name,
                                jct_s=rec.jct)
