"""Deterministic sharded data pipeline with exact-resume state (port of
``repro.data.pipeline``: pure numpy, the same batches bit for bit).

Production constraints honored here:
  * each host loads only its shard of the global batch (per-process
    loading on a multi-host mesh);
  * the stream is a pure function of (seed, step) — restart at step k
    reproduces the same batches with no replay log;
  * pipeline state is two integers, carried in every checkpoint;
  * background prefetch with a bounded queue (overlaps host->device).

The corpus is synthetic (a mixture of Zipf-distributed token n-gram
"documents") — the assignment requires the substrate, not a dataset.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


@dataclasses.dataclass
class PipelineState:
    step: int = 0
    seed: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "PipelineState":
        return PipelineState(step=int(d["step"]), seed=int(d["seed"]))


def _batch_for_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function of (cfg.seed, step, host): the resume guarantee."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    B, S = cfg.host_batch, cfg.seq_len
    # Zipf tokens, clipped into vocab; documents delimited by token 0
    toks = rng.zipf(cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
    toks = np.minimum(toks, cfg.vocab - 1).astype(np.int32)
    doc_ends = rng.random((B, S + 1)) < (1.0 / 512)
    toks = np.where(doc_ends, 0, toks)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DataPipeline:
    """Iterator with deterministic state + background prefetch."""

    def __init__(self, cfg: DataConfig, state: Optional[PipelineState] = None,
                 prefetch: int = 2):
        self.cfg = cfg
        self.state = state or PipelineState(seed=cfg.seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- synchronous API ---------------------------------------------------
    def next_batch(self) -> Dict[str, np.ndarray]:
        b = _batch_for_step(self.cfg, self.state.step)
        self.state.step += 1
        return b

    def peek_step(self, step: int) -> Dict[str, np.ndarray]:
        return _batch_for_step(self.cfg, step)

    # -- prefetching API ---------------------------------------------------
    def start(self):
        def worker():
            step = self.state.step
            while not self._stop.is_set():
                try:
                    self._q.put((step, _batch_for_step(self.cfg, step)),
                                timeout=0.1)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def get(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.state.step = step + 1
        return batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
