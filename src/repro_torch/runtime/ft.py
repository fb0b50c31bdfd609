"""Fault tolerance & straggler mitigation for 1000+ node operation (port
of ``repro.runtime.ft``, the same semantics: a step that still fails
after its retries restores the last committed checkpoint and rewinds,
and the loop tries again, for as long as it takes).

What actually fails at scale and what this module does about it:

* **Chip/host failure mid-step** → the step raises; ``FaultTolerantLoop``
  catches, restores the last committed checkpoint (written every
  ``ckpt_every`` steps, asynchronously), rebuilds the mesh from the
  surviving device set via ``repro_torch.ckpt.elastic.resize_plan``, and
  resumes from the exact data-pipeline state (the pipeline is a pure
  function of (seed, step)).
* **Stragglers** → synchronous SPMD steps run at the speed of the
  slowest participant.  ``StragglerMonitor`` keeps an EWMA of step time;
  when a step exceeds ``threshold``× the EWMA it records the event and
  (at the cluster level) the policy recommendation is eviction +
  elastic resize — the hierarchical ScalePool schedule also CONTAINS a
  slow pod: only the inter-pod phase (1/|data| of bytes) waits on it.
* **Transient errors** (preemption notices, DMA timeouts) → bounded
  retry with backoff before escalating to restore.
* **A failed step on a grid of more than one rank** → a world restart.
  Every forward pass under tensor parallelism holds collectives, so a
  rank that re-ran its step alone would pair its collectives with the
  other ranks' next ones.  With ``ranks`` over 1 the loop neither
  retries nor restores: the failure leaves the loop and ends the
  process, ``torch.distributed.run --max-restarts N`` stops every rank
  and re-forms the world, and each rank restores the last committed
  checkpoint (written after the same step on every rank) and rewinds
  the pipeline to its step: the reference's restore-and-rewind, for the
  whole world at once (``repro_torch.launch.train``).

The single-process tests exercise all of this with injected failures
(tests/test_torch_train.py); metrics may be 0-d tensors on the card
(read with ``float``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker with a slowdown threshold."""

    alpha: float = 0.1
    threshold: float = 2.0
    ewma: Optional[float] = None
    events: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler event."""
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.threshold * self.ewma
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
        # stragglers don't poison the EWMA
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * min(
            dt, self.threshold * self.ewma)
        return is_straggler

    def recommendation(self) -> str:
        if len(self.events) >= 3:
            return "evict-and-resize"
        if self.events:
            return "monitor"
        return "healthy"


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 2
    backoff_s: float = 0.5

    def run(self, fn: Callable[[], Any]) -> Any:
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001
                last = e
                if attempt < self.max_retries:
                    time.sleep(self.backoff_s * (2 ** attempt))
        raise last  # type: ignore[misc]


class FaultTolerantLoop:
    """Checkpointed training loop with failure injection hooks.

    train_step: (state, batch) -> (state, metrics)
    save_fn:    (state, step) -> None       (async checkpoint)
    restore_fn: () -> (state, step)         (last committed checkpoint)
    ranks:      the world's rank count; over 1 a failing step raises out
                of ``run`` (the world restarts, see the module's doc)
    """

    def __init__(self, train_step, save_fn, restore_fn, pipeline, *,
                 ckpt_every: int = 50,
                 retry: RetryPolicy = RetryPolicy(),
                 monitor: Optional[StragglerMonitor] = None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 ranks: int = 1):
        self.train_step = train_step
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.pipeline = pipeline
        self.ckpt_every = ckpt_every
        self.retry = retry
        self.monitor = monitor or StragglerMonitor()
        self.failure_hook = failure_hook
        self.ranks = ranks
        self.restarts = 0
        self.start_step = 0
        self.history: List[Dict[str, float]] = []

    def run(self, state, n_steps: int):
        """Train until ``n_steps``; returns the last state.  ``state``
        None starts from ``restore_fn()`` and its step: then the loop
        holds the only reference to the state it trains, where a state
        passed in stays referenced by the caller for the whole run."""
        step = 0
        if state is None:
            state, step = self.restore_fn()
            self.pipeline.state.step = step
        self.start_step = step
        while step < n_steps:
            def attempt():
                if self.failure_hook is not None:
                    self.failure_hook(step)  # may raise (injected failure)
                batch = self.pipeline.peek_step(step)
                t0 = time.time()
                new_state, metrics = self.train_step(state, batch)
                dt = time.time() - t0
                return new_state, metrics, dt

            if self.ranks > 1:
                state, metrics, dt = attempt()
            else:
                try:
                    state, metrics, dt = self.retry.run(attempt)
                except Exception:
                    # unrecoverable step: restore + rewind
                    state, ckpt_step = self.restore_fn()
                    self.pipeline.state.step = ckpt_step
                    step = ckpt_step
                    self.restarts += 1
                    continue

            self.monitor.observe(step, dt)
            self.history.append({"step": step, **{
                k: float(v) for k, v in metrics.items()}})
            step += 1
            self.pipeline.state.step = step
            if step % self.ckpt_every == 0:
                self.save_fn(state, step)
        return state
