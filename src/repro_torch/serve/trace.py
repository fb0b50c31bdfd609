"""Request-arrival traces, the trace → engine driver and the
clock-interleaved multi-tenant driver.

Traces are deterministic (seeded numpy), expressed in *modeled* seconds
— the same clock the engine's ``ServeCostModel`` advances — so a trace
run is exactly reproducible across hosts and arrival interleavings.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.analysis import tiebreak
from repro_torch.serve.api import Request, RequestHandle


def synthetic_trace(n_requests: int, *,
                    mean_interarrival_s: float = 0.05,
                    prompt_lens: Sequence[int] = (16, 32, 64),
                    max_new_tokens: int = 16,
                    vocab: int = 256,
                    seed: int = 0) -> List[Request]:
    """Poisson-ish arrivals, cycling prompt lengths, random token ids."""
    rng = np.random.RandomState(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        t += float(rng.exponential(mean_interarrival_s))
        plen = prompt_lens[i % len(prompt_lens)]
        prompt = rng.randint(1, vocab, size=plen).tolist()
        out.append(Request(prompt_tokens=tuple(prompt),
                           max_new_tokens=max_new_tokens,
                           arrival_time=t))
    return out


def burst_trace(n_requests: int, *, prompt_len: int = 32,
                max_new_tokens: int = 32, vocab: int = 256,
                seed: int = 0) -> List[Request]:
    """Everything arrives at t=0 — the heaviest contention shape."""
    rng = np.random.RandomState(seed)
    return [Request(tuple(rng.randint(1, vocab, size=prompt_len).tolist()),
                    max_new_tokens, arrival_time=0.0)
            for _ in range(n_requests)]


def load_trace(path: str, *, vocab: Optional[int] = None) -> List[Request]:
    """JSONL: {"prompt_tokens": [...], "max_new_tokens": n, "arrival_time": t}.

    Pass ``vocab`` to validate token ids at load time: an id >= vocab
    would index past the embedding table (a device-side assert on the
    card), so a bad trace line raises here with its line number
    instead.  ``Engine.submit``
    re-validates as a backstop.
    """
    out = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            toks = tuple(int(t) for t in d["prompt_tokens"])
            if vocab is not None:
                bad = [t for t in toks if not 0 <= t < vocab]
                if bad:
                    raise ValueError(
                        f"{path}:{lineno}: prompt token id {bad[0]} outside "
                        f"the model vocab [0, {vocab})")
            out.append(Request(toks, int(d["max_new_tokens"]),
                               float(d.get("arrival_time", 0.0))))
    return out


def run_trace(engine, trace: Sequence[Request], *,
              max_steps: int = 200_000) -> List[RequestHandle]:
    """Feed arrivals as modeled time passes; step until drained."""
    pending = sorted(trace, key=lambda r: r.arrival_time)
    handles: List[RequestHandle] = []
    i = 0
    for _ in range(max_steps):
        while i < len(pending) and pending[i].arrival_time <= engine.clock:
            handles.append(engine.submit(pending[i]))
            i += 1
        if engine.idle:
            if i >= len(pending):
                return handles
            engine.advance_clock(pending[i].arrival_time)
            continue
        engine.step()
    raise RuntimeError(f"trace not drained after {max_steps} steps")


def run_multi_trace(pairs, *, max_steps: int = 1_000_000
                    ) -> List[List[RequestHandle]]:
    """Drive several engines — typically tenants of one ``PoolArbiter``
    — over per-engine arrival traces, interleaved by modeled clock.

    Each round the engine with the earliest next event (its clock if it
    has work, else its next arrival) steps once; arrivals are fed when
    that engine's clock reaches them.  An engine whose step makes no
    modeled progress (blocked on pages another tenant holds) has its
    clock synced forward to the next other-engine event and is skipped
    until some tenant progresses; if every engine is blocked at once,
    that is a cross-tenant deadlock and this raises rather than spins.

    Returns one handle list per (engine, trace) pair, in order.
    """
    state = [[eng, sorted(tr, key=lambda r: r.arrival_time), 0, []]
             for eng, tr in pairs]
    blocked: set = set()
    for _ in range(max_steps):
        for st in state:
            eng, pend = st[0], st[1]
            while st[2] < len(pend) \
                    and pend[st[2]].arrival_time <= eng.clock:
                st[3].append(eng.submit(pend[st[2]]))
                st[2] += 1
        cands = []
        for j, (eng, pend, i, _) in enumerate(state):
            if not eng.idle:
                cands.append((eng.clock, j))
            elif i < len(pend):
                cands.append((pend[i].arrival_time, j))
        if not cands:
            return [st[3] for st in state]
        live = [c for c in cands if c[1] not in blocked]
        if not live:
            raise RuntimeError(
                "multi-tenant deadlock: every engine is blocked on pages "
                "another tenant holds")
        # candidate-list order is incidental: selection is a total-order
        # min over (clock, engine index) — equal clocks break by index
        t, j = min(tiebreak.order(live))
        eng, pend = state[j][0], state[j][1]
        if eng.idle:
            eng.advance_clock(t)
            while state[j][2] < len(pend) \
                    and pend[state[j][2]].arrival_time <= eng.clock:
                state[j][3].append(eng.submit(pend[state[j][2]]))
                state[j][2] += 1
        before = eng.clock
        dt = eng.step()
        # identity test: did step() assign a new clock value at all
        if dt > 0.0 or eng.idle or eng.clock != before:
            blocked.clear()
        else:
            others = [c[0] for c in cands if c[1] != j]
            if others:
                eng.advance_clock(min(others))
            blocked.add(j)
    raise RuntimeError(f"multi-tenant traces not drained after "
                       f"{max_steps} steps")


def latency_summary(handles: Sequence[RequestHandle]) -> Dict[str, float]:
    """Nearest-rank percentiles (ceil(p*n) - 1 into the sorted sample):
    the p-th percentile is the smallest observation covering at least a
    p fraction of the sample.  The old ``int(p * n)`` indexing biased a
    rank high — for n = 2 it reported the *max* as the median."""
    lats = sorted(h.latency for h in handles if h.latency is not None
                  and h.status.value == "done")
    if not lats:
        return {"n": 0, "p50_s": float("inf"), "p95_s": float("inf"),
                "mean_s": float("inf")}
    pct = lambda p: lats[max(0, math.ceil(p * len(lats)) - 1)]
    return {"n": len(lats), "p50_s": pct(0.50), "p95_s": pct(0.95),
            "mean_s": sum(lats) / len(lats)}
