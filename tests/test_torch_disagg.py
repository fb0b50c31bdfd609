"""Disaggregated prefill/decode: the port's ``repro_torch.disagg`` and the
engine's handoff seams against the reference's ``repro.disagg``.

The same traces and topology (``tests/test_disagg.py``'s helpers,
restated) go through both packages: a prefill worker exports each
prompt's KV page by page, the router streams the pages over the shared
``Transport`` (direct pod to pod, or staged through a tier-2 memory
node) and plants the request on the decode engine through
``submit_prefilled``.  Tokens, handle clocks, ``kv_transit_s``, the
cluster's handoff and colocation counts and ``Transport.stats()`` must
be equal, ``repro.analysis.tracediff`` must find no divergence between
the two traces, and the reference's sanitizer must pass the port's
trace with its ``disagg-handoff`` rule exercised.  Then the port alone:
the degenerate cluster (``route=None``) replays ``run_trace(Engine)``
bit for bit, the cluster is bit-identical under the tiebreak
perturbation, the validation errors, ``decode_load`` counting
handoffs, and the CLI's ``--disagg`` against the reference CLI.

Both models compute in fp32 on the CPU, the port's weights taken from
the reference's ``model.init`` through the bridge."""

import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import disagg as ref_disagg                        # noqa: E402
from repro import serve as ref_serve                          # noqa: E402
from repro.analysis.sanitizer import sanitize_trace_doc       # noqa: E402
from repro.analysis.tracediff import diff_trace_docs          # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.core import fabric as ref_fb                       # noqa: E402
from repro.fabric import Topology as RefTopology              # noqa: E402
from repro.fabric import Transport as RefTransport            # noqa: E402
from repro.launch.serve import main as ref_main               # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import Tracer as RefTracer                     # noqa: E402
from repro.obs import to_chrome_trace as ref_chrome           # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch import disagg as port_disagg                 # noqa: E402
from repro_torch import serve as port_serve                   # noqa: E402
from repro_torch.analysis import tiebreak                     # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.core import fabric as port_fb                # noqa: E402
from repro_torch.disagg import (DisaggCluster, DisaggConfig,  # noqa: E402
                                PrefillWorker, decode_load,
                                pick_decode_engine)
from repro_torch.fabric import Topology, Transport            # noqa: E402
from repro_torch.launch.serve import main                     # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.obs import Tracer, to_chrome_trace           # noqa: E402
from repro_torch.serve import (Engine, Request,                # noqa: E402
                               RequestStatus, run_trace)

ARCH = "qwen1.5-0.5b"
VOCAB = SMOKE_ARCHS[ARCH].vocab
STALLED_BW = 3 * 16384.0        # ~3 pages of the smoke model per second
FAST_BW = 200.0 * 16384.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only contend with
    the other test workers' (several times slower under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    ref = ref_build(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    params = bridge.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, port, params


@pytest.fixture(scope="module")
def model(models):
    return models[2]


@pytest.fixture(scope="module")
def params(models):
    return models[3]


# one namespace per package, so a scenario is written once for both
REF = types.SimpleNamespace(
    serve=ref_serve, disagg=ref_disagg, fb=ref_fb, Topology=RefTopology,
    Transport=RefTransport, Tracer=RefTracer, kw={})
PORT = types.SimpleNamespace(
    serve=port_serve, disagg=port_disagg, fb=port_fb, Topology=Topology,
    Transport=Transport, Tracer=Tracer, kw={"device": "cpu"})


def _cfg(S, **kw):
    base = dict(max_slots=3, max_seq=64, page_size=8)
    base.update(kw)
    return S.serve.EngineConfig(**base)


def _trace(S, n=6, prompt=12, new=6, seed=0):
    return S.serve.burst_trace(n, prompt_len=prompt, max_new_tokens=new,
                               vocab=VOCAB, seed=seed)


def _topology(S, *, bw):
    """One leaf switch, two pods, one tier-2 memory node."""
    topo = S.Topology("disagg-test")
    topo.add_node("leaf", "switch")
    for p in (0, 1):
        topo.add_node(f"pod:{p}", "pod")
        topo.connect(f"pod:{p}", "leaf", S.fb.CXL3, capacity=bw,
                     latency=1e-4)
    topo.add_node("mem:0", "memory")
    topo.connect("mem:0", "leaf", S.fb.CXL_CAPACITY, capacity=2 * bw,
                 latency=1e-4)
    return topo


def _routed(S, model, params, *, bw, config, tracer, tenant="t0"):
    topo = _topology(S, bw=bw)
    tx = S.Transport(topo, tracer=tracer)
    pw = S.disagg.PrefillWorker(
        S.serve.Engine.local(model, _cfg(S), params=params, tracer=tracer,
                             **S.kw), name="p0")
    de = S.serve.Engine.local(model, _cfg(S), params=params, tracer=tracer,
                              **S.kw)
    kw = dict(transport=tx, route=topo.route("pod:0", "pod:1"),
              config=config)
    if config.staging == "tier2":
        kw["stage_in"] = topo.route("pod:0", "mem:0")
        kw["stage_out"] = topo.route("mem:0", "pod:1")
    return S.disagg.DisaggCluster([pw], [de], tenant=tenant, **kw), tx


def _outcome(cluster, tx, handles):
    return {
        "tokens": [list(h.tokens) for h in handles],
        "clocks": [(h.submit_clock, h.first_token_clock, h.done_clock)
                   for h in handles],
        "transit": [h.kv_transit_s for h in handles],
        "status": [h.status.value for h in handles],
        "handoffs": cluster.handoffs, "colocated": cluster.colocated,
        "transport": tx.stats(),
        "engine": cluster.decode_engines[0].stats(),
    }


def _run(S, model, params, *, bw, config, n=6, new=6):
    tracer = S.Tracer(1 << 18)
    cluster, tx = _routed(S, model, params, bw=bw, config=config,
                          tracer=tracer)
    handles = cluster.run(_trace(S, n=n, new=new))
    tx.quiesce()
    assert tracer.dropped == 0
    return _outcome(cluster, tx, handles), tracer, handles


# (staging, min_ready_pages, max_transit_s, max_prefill_depth, bw, new)
CASES = {
    "direct": ("direct", None, None, None, FAST_BW, 6),
    "tier2": ("tier2", None, None, None, FAST_BW, 6),
    "direct-min-ready-1": ("direct", 1, None, None, FAST_BW, 6),
    "tier2-min-ready-1": ("tier2", 1, None, None, FAST_BW, 6),
    "stalled-kv": ("direct", None, None, None, STALLED_BW, 6),
    "stalled-kv-tier2-min-ready-1": ("tier2", 1, None, None, STALLED_BW, 6),
    "max-transit-fallback": ("direct", None, 0.0, None, FAST_BW, 6),
    "max-transit-under": ("direct", None, 1.0, None, STALLED_BW, 6),
    "max-prefill-depth-fallback": ("direct", None, None, 0, FAST_BW, 6),
    "max-prefill-depth-1": ("direct", None, None, 1, STALLED_BW, 6),
    "max-new-tokens-1": ("direct", None, None, None, STALLED_BW, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_matches_reference(models, case):
    ref, ref_params, port, params = models
    staging, min_ready, max_transit, max_depth, bw, new = CASES[case]
    runs = []
    for S, m, p in ((REF, ref, ref_params), (PORT, port, params)):
        config = S.disagg.DisaggConfig(
            staging=staging, min_ready_pages=min_ready,
            max_transit_s=max_transit, max_prefill_depth=max_depth)
        runs.append(_run(S, m, p, bw=bw, config=config, new=new))
    (ref_out, ref_tracer, _), (out, tracer, handles) = runs
    assert out == ref_out
    assert all(h.status is RequestStatus.DONE for h in handles)
    diff = diff_trace_docs(ref_chrome(ref_tracer), to_chrome_trace(tracer))
    assert diff.identical, diff.format()
    report = sanitize_trace_doc(to_chrome_trace(tracer))
    assert report.ok, report.format()
    if out["handoffs"] and new > 1:
        assert report.checks["disagg-handoff"] > 0
        uses = [e for e in tracer.events() if e.name == "handoff_use"]
        assert len(uses) == out["handoffs"]
        assert all(e.ts >= e.args["ready_ts"] for e in uses)
    if case.startswith("stalled"):
        assert all(h.kv_transit_s > 0.0 for h in handles)
        for h in handles:
            assert h.done_clock >= h.first_token_clock + h.kv_transit_s
    if case.endswith("fallback"):
        assert out["colocated"] == len(handles) and out["handoffs"] == 0
    if case == "max-transit-under":
        assert out["handoffs"] == len(handles)
    if case == "max-prefill-depth-1":
        assert out["colocated"] and out["handoffs"]


def test_routed_tokens_equal_colocated(model, params):
    """Disaggregated prefill -> fabric -> decode gives the colocated
    engine's tokens, over both stagings and with partial admission."""
    want = [h.tokens for h in run_trace(
        Engine.local(model, _cfg(PORT), params=params, device="cpu"),
        _trace(PORT))]
    for staging in ("direct", "tier2"):
        for min_ready in (None, 1):
            out = _run(PORT, model, params, bw=STALLED_BW,
                       config=DisaggConfig(staging=staging,
                                           min_ready_pages=min_ready))[0]
            assert out["tokens"] == want, (staging, min_ready)
            assert out["handoffs"] == len(want)


def test_degenerate_cluster_replays_engine_bit_for_bit(model, params):
    """route=None + one decode engine: the cluster's run loop gives
    ``run_trace(Engine)``'s tokens, clocks and trace events, in order,
    with an idle prefill worker attached."""
    trace = _trace(PORT)
    tr_a, tr_b = Tracer(), Tracer()
    plain = run_trace(Engine.local(model, _cfg(PORT), params=params,
                                   tracer=tr_a, device="cpu"), trace)
    idle_worker = PrefillWorker(
        Engine.local(model, _cfg(PORT), params=params, device="cpu"),
        name="idle")
    cl = DisaggCluster([idle_worker],
                       [Engine.local(model, _cfg(PORT), params=params,
                                     tracer=tr_b, device="cpu")])
    assert cl.degenerate
    got = cl.run(trace)
    assert [h.tokens for h in got] == [h.tokens for h in plain]
    assert [(h.submit_clock, h.first_token_clock, h.done_clock)
            for h in got] == \
        [(h.submit_clock, h.first_token_clock, h.done_clock)
         for h in plain]
    key = lambda t: [(e.ph, e.track, e.name, e.ts, e.dur, e.args)
                     for e in t.events()]
    assert key(tr_b) == key(tr_a)
    assert cl.handoffs == 0 and cl.colocated == len(trace)
    assert idle_worker.prefilled == 0


def test_export_pages_equal_colocated_pool_pages(model, params):
    """``prefill_export``'s first token and page payloads are the
    colocated admission's: the pages a decode engine holds after a
    handoff are bitwise those a colocated prefill writes, and each
    exported page owns its bytes."""
    prompt = _trace(PORT, n=1, prompt=20)[0].prompt_tokens
    exporter = Engine.local(model, _cfg(PORT), params=params, device="cpu")
    tok, pages, cost = exporter.prefill_export(prompt)
    assert len(pages) == -(-len(prompt) // 8)
    assert cost == exporter.cost.prefill_s(32)
    assert exporter._buckets_used == {32}
    bases = {p[n].untyped_storage().data_ptr() for p in pages for n in p}
    assert len(bases) == 2 * len(pages)

    colo = Engine.local(model, _cfg(PORT), params=params, device="cpu")
    colo.submit(Request(prompt, 4))
    colo._admit(0.0)
    dec = Engine.local(model, _cfg(PORT), params=params, device="cpu")
    h = dec.submit_prefilled(Request(prompt, 4), first_tok=tok,
                             prefill_done=0.0, pages=pages,
                             page_ready=[0.0] * len(pages))
    dec._admit_handoffs(0.0)
    assert h.tokens == colo.handles[0].tokens == [tok]
    for i in range(len(pages)):
        for name in ("k", "v"):
            a = colo._pool[name][:, colo._table[0, i]]
            b = dec._pool[name][:, dec._table[0, i]]
            assert torch.equal(a, b), (i, name)


def _perturbable(model, params):
    tracer = Tracer(1 << 18)
    cl, tx = _routed(PORT, model, params, bw=STALLED_BW,
                     config=DisaggConfig(min_ready_pages=1), tracer=tracer)
    handles = cl.run(_trace(PORT, n=4))
    tx.quiesce()
    return _outcome(cl, tx, handles), list(tracer.events())


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_cluster_bit_identical_under_tiebreak_perturbation(model, params,
                                                           seed):
    base, base_events = _perturbable(model, params)
    with tiebreak.perturb(seed):
        got, events = _perturbable(model, params)
    assert got == base
    assert events == base_events


def test_config_and_cluster_validation(model, params):
    with pytest.raises(ValueError, match="staging"):
        DisaggConfig(staging="bounce")
    with pytest.raises(ValueError, match="min_ready_pages"):
        DisaggConfig(min_ready_pages=0)
    eng = Engine.local(model, _cfg(PORT), params=params, device="cpu")
    with pytest.raises(ValueError, match="decode engine"):
        DisaggCluster([], [])
    with pytest.raises(ValueError, match="transport"):
        DisaggCluster([], [eng],
                      route=_topology(PORT, bw=FAST_BW).route("pod:0",
                                                              "pod:1"))
    topo = _topology(PORT, bw=FAST_BW)
    with pytest.raises(ValueError, match="stage"):
        DisaggCluster([], [eng], transport=Transport(topo),
                      route=topo.route("pod:0", "pod:1"),
                      config=DisaggConfig(staging="tier2"))


def test_handoff_seam_validation(model, params):
    eng = Engine.local(model, _cfg(PORT), params=params, device="cpu")
    worker = PrefillWorker(eng)
    with pytest.raises(ValueError, match="vocab"):
        worker.submit(Request((1, VOCAB), 2))
    with pytest.raises(ValueError, match="max_seq"):
        worker.submit(Request((1,) * 60, 8))
    tok, pages, _ = eng.prefill_export((1, 2, 3))
    with pytest.raises(ValueError, match="ready times"):
        eng.submit_prefilled(Request((1, 2, 3), 4), first_tok=tok,
                             prefill_done=0.0, pages=pages, page_ready=[])
    with pytest.raises(ValueError, match="no KV pages"):
        eng.submit_prefilled(Request((1, 2, 3), 4), first_tok=tok,
                             prefill_done=0.0, pages=[], page_ready=[])
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit_prefilled(Request((1, 2, 3), 62), first_tok=tok,
                             prefill_done=0.0, pages=pages,
                             page_ready=[0.0])
    # max_new_tokens == 1: the prefill tier's token finishes the request
    h = eng.submit_prefilled(Request((1, 2, 3), 1), first_tok=tok,
                             prefill_done=0.5, pages=pages,
                             page_ready=[9.0])
    assert h.done and h.tokens == [tok] and h.done_clock == 0.5
    assert eng.idle


def test_decode_load_counts_handoffs(model, params):
    eng = Engine.local(model, _cfg(PORT), params=params, device="cpu")
    other = Engine.local(model, _cfg(PORT), params=params, device="cpu")
    assert decode_load(eng) == 0
    eng.submit(Request((1, 2, 3), 2))
    assert decode_load(eng) == 1
    tok, pages, _ = other.prefill_export((4, 5, 6))
    eng.submit_prefilled(Request((4, 5, 6), 3), first_tok=tok,
                         prefill_done=0.0, pages=pages, page_ready=[5.0])
    assert decode_load(eng) == 2 and len(eng._handoffs) == 1
    assert not eng.idle
    assert pick_decode_engine([eng, other]) == 1
    # the pending handoff gates the idle advance: the engine jumps to
    # its page's arrival, then admits and decodes it there
    eng.run_until_idle()
    assert eng.handles[1].done and eng.handles[1].done_clock >= 5.0


# ---------------------------------------------------------------------------
# the CLI's --disagg against the reference CLI
# ---------------------------------------------------------------------------

CLI_ARGS = ["--smoke", "--requests", "8", "--max-new", "6", "--slots", "3",
            "--max-seq", "96", "--page-size", "16", "--prompt-lens",
            "32,16", "--interarrival", "0.001", "--disagg"]


@pytest.mark.parametrize("extra", [[], ["--disagg-staging", "tier2",
                                        "--min-ready-pages", "1"]],
                         ids=["direct", "tier2-min-ready-1"])
def test_cli_disagg_matches_reference(capsys, extra):
    """The modeled fields of ``--disagg``'s JSON equal the reference
    CLI's; the sampled tokens differ (each package draws its own random
    weights)."""
    assert main(CLI_ARGS + extra + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert ref_main(CLI_ARGS + extra) == 0
    ref_out = json.loads(capsys.readouterr().out)
    assert out.pop("device") == "cpu"
    for d in (out, ref_out):
        d.pop("wall_s"), d.pop("sample_tokens")
    assert out == ref_out
    assert out["mode"] == "disagg" and out["handoffs"] == 8
