"""The disaggregated scenarios ``tests/test_torch_disagg_tp.py`` holds the
port's tiers on a ``model``-axis lease to the reference's local cluster
with, written once for both packages (``S``: a namespace of ``serve``,
``disagg``, ``fb``, ``Topology``, ``Transport``, ``Tracer``).

fig12's shape at smoke size, as ``tests/test_torch_disagg.py`` restates
it: 3-slot engines of 8-token pages, one leaf switch over two pods and
a tier-2 memory node, link capacities in pages of the smoke model per
second.  The burst alternates 12- and 28-token prompts (2 and 4 pages),
so a transit limit between their predicted transits sends the longer
prompts colocated; the decode engines hold an 8-page tier-1 quota over
tier 2, under which the colocated prefills of the fallback and the
degenerate cluster pause rows and spill.  Torch-free at
import: the world's ranks import it beside the port alone.
"""

from __future__ import annotations

STALLED_BW = 3 * 16384.0        # ~3 pages of the smoke model per second
FAST_BW = 200.0 * 16384.0
ENGINE = dict(max_slots=3, max_seq=64, page_size=8)
DECODE_BUDGET = dict(tier1_pages=8, tier2_bytes=1e9)
PROMPTS = (12, 28)
N_EACH, MAX_NEW = 3, 6

# name: staging, min_ready_pages, transit limit between the prompts'
# predicted transits, link capacity, prefill workers, decode engines,
# routed (False: the degenerate cluster, route=None)
CASES = {
    "direct": ("direct", None, False, FAST_BW, 1, 1, True),
    "tier2": ("tier2", 1, False, STALLED_BW, 1, 1, True),
    "colocated_fallback": ("direct", None, True, STALLED_BW, 1, 1, True),
    "two_by_two": ("direct", 1, False, STALLED_BW, 2, 2, True),
    "degenerate": ("direct", None, False, FAST_BW, 1, 1, False),
}


def trace(S, vocab):
    """Six requests at t=0, 12- and 28-token prompts in turn."""
    a, b = (S.serve.burst_trace(N_EACH, prompt_len=n, max_new_tokens=MAX_NEW,
                                vocab=vocab, seed=i)
            for i, n in enumerate(PROMPTS))
    return [r for pair in zip(a, b) for r in pair]


def engine_config(S):
    return S.serve.EngineConfig(**ENGINE)


def budget(S, role):
    """The decode engines' quota over tier 2; the prefill engines'
    default (they only export)."""
    if role == "decode":
        return S.serve.KVBudget(page_size=ENGINE["page_size"],
                                **DECODE_BUDGET)
    return S.serve.KVBudget(page_size=ENGINE["page_size"])


def topology(S, bw):
    """One leaf switch, two pods, one tier-2 memory node."""
    topo = S.Topology("disagg-tp")
    topo.add_node("leaf", "switch")
    for p in (0, 1):
        topo.add_node(f"pod:{p}", "pod")
        topo.connect(f"pod:{p}", "leaf", S.fb.CXL3, capacity=bw,
                     latency=1e-4)
    topo.add_node("mem:0", "memory")
    topo.connect("mem:0", "leaf", S.fb.CXL_CAPACITY, capacity=2 * bw,
                 latency=1e-4)
    return topo


def run(S, case, make_engine, vocab):
    """``case``'s cluster over engines ``make_engine(role, tenant,
    tracer)`` gives (role ``"prefill"`` or ``"decode"``), traced, driven
    through ``trace``.  Returns (cluster, transport or None, handles,
    tracer)."""
    staging, min_ready, fallback, bw, n_pre, n_dec, routed = CASES[case]
    tracer = S.Tracer(1 << 18)
    workers = [S.disagg.PrefillWorker(make_engine("prefill", None, tracer),
                                      name=f"p{i}") for i in range(n_pre)]
    dengines = [make_engine("decode", f"d{k}", tracer) for k in range(n_dec)]
    tx = None
    if not routed:
        cluster = S.disagg.DisaggCluster(workers, dengines)
    else:
        topo = topology(S, bw)
        tx = S.Transport(topo, tracer=tracer)
        route = topo.route("pod:0", "pod:1")
        limit = None
        if fallback:
            pb = dengines[0].kv.page_bytes
            pages = [-(-n // ENGINE["page_size"]) for n in PROMPTS]
            limit = sum(route.transfer_time(k * pb) for k in pages) / 2
        kw = {}
        if staging == "tier2":
            kw = dict(stage_in=topo.route("pod:0", "mem:0"),
                      stage_out=topo.route("mem:0", "pod:1"))
        cluster = S.disagg.DisaggCluster(
            workers, dengines, transport=tx, route=route, tenant="kv",
            config=S.disagg.DisaggConfig(staging=staging,
                                         min_ready_pages=min_ready,
                                         max_transit_s=limit), **kw)
    handles = cluster.run(trace(S, vocab))
    if tx is not None:
        tx.quiesce()
    return cluster, tx, handles, tracer


def outcome(cluster, tx, handles):
    """What the reference's run is held to: tokens, every handle's
    clocks and KV transit, the cluster's handoffs and colocated
    requests, the shared transport's stats and each decode engine's."""
    return {
        "tokens": [list(h.tokens) for h in handles],
        "clocks": [(h.submit_clock, h.first_token_clock, h.done_clock)
                   for h in handles],
        "transit": [h.kv_transit_s for h in handles],
        "status": [h.status.value for h in handles],
        "handoffs": cluster.handoffs, "colocated": cluster.colocated,
        "transport": None if tx is None else tx.stats(),
        "engines": [e.stats() for e in cluster.decode_engines],
    }
