"""The request-level engine serving the moe family across ranks: expert
parallelism over ``model`` (olmoe smoke's 8 experts, mixtral smoke's 4,
half a rank) and each decode bucket's rows over ``data``, the dispatch
group the whole bucket.

Worlds over gloo (``tests/_dist_world.py``, one thread a rank) serve
olmoe-1b-7b smoke (4 heads, 4 kv heads, 2 layers, top-2 of 8) and
mixtral-8x7b smoke (4 heads, 2 kv heads, top-2 of 4) in fp32 from the
reference's parameters with ``Engine.from_lease``, all at once:

* olmoe on (data 1, model 2), (data 2, model 2) and (data 2, model 1),
  and two tenants of one lease over one arbiter on (data 2, model 2);
* mixtral on (data 1, model 2) and (data 2, model 2).

The trace is ``tests/test_torch_serve_dp.py``'s (buckets of 1, 2 and 4
rows, spills and fetches, rows that resume into another slot); at the
configured capacity factor 1.25 a decode bucket of 4 rows gives each of
olmoe's experts one slot, so decode steps drop entries (asserted on the
ranks' ``record_routing``).  Each world is held to the reference's local
engine (its lease path fails on this tree's jax, ROADMAP C-ref1): tokens,
every handle's clocks, the latency summary and ``stats()`` ``==`` the
reference's on every rank, ``tracediff`` finds no divergence and the
sanitizer passes; the data replicas of one ``model`` block hold pools
equal in bits, layer 0 within 1e-6 of the one-process port pool's
kv-head slice (a one-row block takes torch's matrix-vector path) and the
later layer within 1e-5.  The collectives: per decode step one gather of
the rows' K/V over ``data`` and one gather of the entries' experts a
layer (``moe-experts``); per model call the expert layers' sums over ``model``
(``moe``).
"""

import concurrent.futures
import dataclasses
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import serve as ref_serve                          # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import Tracer as RefTracer                     # noqa: E402
from repro.obs import to_chrome_trace as ref_chrome           # noqa: E402
from repro.pool import smoke_pool as ref_smoke_pool           # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import load, run_world                       # noqa: E402
import test_torch_serve_dp as dp                              # noqa: E402
from test_torch_serve_dp import (LATER_LAYERS_TOL, LAYER0_TOL,  # noqa: E402
                                 RUN, TENANTS, _decode_buckets, _outcome,
                                 _requests, _rows, _tenant_traces)

from repro_torch import analysis, bridge, serve               # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.pool import smoke_pool                       # noqa: E402

# (name, slots, tier-1 pages): tests/test_torch_serve_dp.py's, and an
# engine of 8 slots over ``_requests8``, whose full buckets (rows in slot
# order) hold idle rows in both data blocks as requests end
CASES = {**dp.CASES, "engine8": ("engine8", 8, 48)}
# world: (ranks, the lease's accelerators, model_parallel, mesh, arch,
# cases)
WORLDS = {
    "olmoe_data1_model2": (2, 2, 2, {"data": 1, "model": 2}, "olmoe-1b-7b",
                           ("engine",)),
    "olmoe_data2_model2": (4, 4, 2, {"data": 2, "model": 2}, "olmoe-1b-7b",
                           ("engine", "tenants", "engine8")),
    "olmoe_data2_model1": (2, 2, 1, {"data": 2, "model": 1}, "olmoe-1b-7b",
                           ("engine", "engine8")),
    "mixtral_data1_model2": (2, 2, 2, {"data": 1, "model": 2},
                             "mixtral-8x7b", ("engine",)),
    "mixtral_data2_model2": (4, 4, 2, {"data": 2, "model": 2},
                             "mixtral-8x7b", ("engine",)),
}
RUNS = [(w, c) for w, spec in WORLDS.items() for c in spec[5]]
# (arch, case) the reference runs
REFS = sorted({(spec[4], c) for spec in WORLDS.values() for c in spec[5]})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(arch):
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype="float32")
    return jax.tree.map(np.asarray, ref_build(cfg).init(jax.random.PRNGKey(0)))


def _requests8(module):
    """engine8's trace: 8 requests at once, the second and the seventh
    (slots 1 and 6) ending first, so a full bucket holds an idle row in
    each data block, the last in the second."""
    rng = np.random.RandomState(1)
    lens = (9, 7, 12, 6, 10, 8, 11, 5)
    new = (30, 6, 28, 26, 24, 22, 9, 20)
    return [module.Request(tuple(rng.randint(1, dp.VOCAB, size=n).tolist()),
                           m, arrival_time=0.0)
            for n, m in zip(lens, new)]


def _trace(module, case):
    return _requests8(module) if case == "engine8" else _requests(module)


def _ecfg(module, case):
    return module.EngineConfig(max_slots=CASES[case][1],
                               max_seq=RUN["max_seq"],
                               page_size=RUN["page_size"])


def _run(module, model, params, case, tracer=None, **kw):
    """``case`` through ``module``'s (``repro.serve`` or
    ``repro_torch.serve``) local engines: (handle lists, engines,
    arbiter or None)."""
    pages = CASES[case][2]
    if case != "tenants":
        eng = module.Engine.local(
            model, _ecfg(module, case), params=params, tracer=tracer,
            budget=module.KVBudget(pages, RUN["tier2_bytes"],
                                   RUN["page_size"]), **kw)
        return [module.run_trace(eng, _trace(module, case))], [eng], None
    pool = (ref_smoke_pool if module is ref_serve else smoke_pool)(
        "scalepool")
    lease = pool.lease("serve-dp-tenants", 4, tier2_gb=64,
                       kv_gb=RUN["kv_gb"], tenants=TENANTS)
    arb = module.PoolArbiter(pages, page_size=RUN["page_size"],
                             tracer=tracer)
    engines = [module.Engine.local(
        model, _ecfg(module, case), params=params, arbiter=arb, tenant=t,
        tracer=tracer, budget=lease.kv_share(t, page_size=RUN["page_size"]),
        **kw) for t in TENANTS]
    traces = _tenant_traces(module)
    return module.run_multi_trace([(e, traces[t]) for e, t in
                                   zip(engines, TENANTS)]), engines, arb


def _reference(arch, case, params_np):
    """The reference's local run of ``case``, traced."""
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype="float32")
    tracer = RefTracer(1 << 16)
    lists, engines, arb = _run(
        ref_serve, ref_build(cfg), jax.tree.map(jax.numpy.asarray, params_np),
        case, tracer)
    out = _outcome(lists, engines, arb)
    out["latency"] = [ref_serve.latency_summary(hs) for hs in lists]
    out["trace"] = ref_chrome(tracer)
    return out


def _one_process(arch, case, params_np):
    """The port's one-process run's pool (every kv head)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32")
    _, engines, arb = _run(
        serve, build_model(cfg, device="cpu"),
        bridge.params_from_reference(params_np, "cpu"), case, device="cpu")
    return engines[0]._pool if arb is None else arb.pool


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_moe_dp")
    params = {a: _params(a) for a in {w[4] for w in WORLDS.values()}}
    tenant_rows = {t: _rows(rs) for t, rs in _tenant_traces(serve).items()}
    pending = {}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        for name, (n, accels, mp, _, arch, cases) in WORLDS.items():
            d = root / name
            d.mkdir()
            with open(d / "params.pkl", "wb") as f:
                pickle.dump(params[arch], f)
            pending[name] = (d, pool.submit(
                run_world, n, "serve_dp", d, timeout=180,
                vocab=SMOKE_ARCHS[arch].vocab, accels=accels,
                model_parallel=mp, cases=[CASES[c] for c in cases],
                requests={c: _rows(_trace(serve, c)) for c in cases},
                tenant_traces=tenant_rows,
                arch=arch, **RUN))
        refs = {(a, c): _reference(a, c, params[a]) for a, c in REFS}
        ones = {(a, c): _one_process(a, c, params[a]) for a, c in REFS}
        out = {}
        for name, (d, done) in pending.items():
            done.result()
            out[name] = [load(d, "serve_dp", r)
                         for r in range(WORLDS[name][0])]
    return refs, ones, out


@pytest.mark.parametrize("world,case", RUNS)
def test_every_rank_serves_the_reference_run(worlds, world, case):
    """Tokens, clocks, latency, stats (row buckets, KV stats) and the
    arbiter's stats ``==`` the reference's local run on every rank; the
    engine's run spills, fetches and runs the 1-, 2- and 4-row buckets,
    the tenants' revokes pages."""
    refs, _, ranks = worlds
    ref = refs[WORLDS[world][4], case]
    if case == "engine":
        kv = ref["stats"][0]["kv"]
        assert kv["spills"] > 0 < kv["fetches"]
        assert set(_decode_buckets(ref["trace"])) == {1, 2, 4}
    elif case == "engine8":
        assert 8 in _decode_buckets(ref["trace"])
    else:
        assert ref["arbiter"]["revoked_pages"] > 0
    for rank in ranks[world]:
        got = rank[case]
        assert rank["grid"]["mesh"] == WORLDS[world][3]
        assert got["one_grid"]
        assert got["tokens"] == ref["tokens"]
        assert got["clocks"] == ref["clocks"]
        assert got["latency"] == ref["latency"]
        assert got["stats"] == ref["stats"]
        assert got["arbiter"] == ref["arbiter"]


@pytest.mark.parametrize("world,case", RUNS)
def test_traces_equal_the_reference_and_sanitize(worlds, world, case):
    refs, _, ranks = worlds
    for rank in ranks[world]:
        got = rank[case]
        assert got["dropped"] == 0
        diff = analysis.diff_trace_docs(refs[WORLDS[world][4], case]["trace"],
                                        got["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(got["trace"])
        assert report.ok, report.format()


@pytest.mark.parametrize("world", [w for w, c in RUNS if c == "engine8"])
def test_idle_rows_read_the_bucket_s_trash_source(worlds, world):
    """In the 8-slot engine a full bucket holds idle rows in a data block
    that lacks the bucket's last idle row, whose K/V every idle row
    reads: such a block's decode calls carry that row as a shadow, one
    row past the block's ceil(b / n)."""
    _, _, ranks = worlds
    n = WORLDS[world][3]["data"]
    shadows = sum(c[0] == 8 // n + 1 for rank in ranks[world]
                  for c in rank["engine8"]["calls"][0])
    assert shadows > 0


@pytest.mark.parametrize("world,case", RUNS)
def test_decode_steps_drop_entries(worlds, world, case):
    """The decode buckets' capacity drops entries: the drops the ranks of
    one ``model`` block saw in their rows, summed, are over 0 (each
    rank counts its own rows only)."""
    _, _, ranks = worlds
    by_model = {}
    for rank in ranks[world]:
        key = rank["grid"]["coords"]["model"]
        by_model[key] = by_model.get(key, 0) + rank[case]["decode_drops"]
    assert len(set(by_model.values())) == 1, by_model
    assert min(by_model.values()) > 0, by_model


@pytest.mark.parametrize("world,case", RUNS)
def test_replicas_hold_one_pool_of_their_kv_heads(worlds, world, case):
    """The data replicas of one ``model`` block hold the same pool in
    bits (the trash page aside); against the rank's kv-head slice of the
    one-process pool, layer 0 within ``LAYER0_TOL`` and the later layer
    within 1e-5."""
    _, ones, ranks = worlds
    full_pool = ones[WORLDS[world][4], case]
    by_model = {}
    for rank in ranks[world]:
        got = rank[case]
        lo, hi = got["kv_heads"]
        trash = got["trash"]
        for name, full in full_pool.items():
            want = full[:, :trash, ..., lo:hi, :]
            mine = got["pool"][name][:, :trash]
            assert mine.shape == want.shape
            top = float(want[0].abs().max())
            assert float((mine[0] - want[0]).abs().max()) <= \
                LAYER0_TOL * top, name
            top = float(want[1:].abs().max())
            assert float((mine[1:] - want[1:]).abs().max()) <= \
                LATER_LAYERS_TOL * top, name
            first = by_model.setdefault((lo, name), mine)
            assert torch.equal(mine, first), (name, rank["grid"])


@pytest.mark.parametrize("world,case", RUNS)
def test_collectives_of_the_whole_bucket_group(worlds, world, case):
    """Per decode step one all-gather of the rows' K/V and tokens over
    the batch axes and one of the entries' experts a layer; per model
    call
    under ``model`` the lookup's and each layer's attention all-reduce,
    each layer's expert sum (``moe``) and the argmax's all-gather."""
    refs, _, ranks = worlds
    names = [e["name"] for e in refs[WORLDS[world][4], case]["trace"]
             ["traceEvents"]]
    decodes, prefills = names.count("decode"), names.count("prefill")
    mesh = WORLDS[world][3]
    layers = SMOKE_ARCHS[WORLDS[world][4]].n_layers
    want = {}
    if mesh["data"] > 1:
        want["data:all-gather"] = decodes
        want["data:all-gather:moe-experts"] = decodes * layers
    if mesh["model"] > 1:
        calls = decodes + prefills
        want["model:all-reduce"] = calls * (1 + layers)
        want["model:all-reduce:moe"] = calls * layers
        want["model:all-gather"] = calls
    for rank in ranks[world]:
        assert rank[case]["collectives"] == want


@pytest.mark.parametrize("mp", [1], ids=["data2"])
def test_cli_serves_moe_across_two_ranks_as_one_process(mp):
    """The serving CLI's engine mode, olmoe-1b-7b smoke (bf16 compute),
    on a lease of 2 accelerators under ``torch.distributed.run
    --nproc-per-node 2``, the rows over data, prints the one-process
    CLI's summary, with ``ranks_agree``.  (Over model its bf16 sums run
    in another order, and at this trace's second decode step the
    one-process run's top-2 logits lie one bf16 ulp apart, a C-ref3 tie;
    the model-axis engine is held in fp32 above.)"""
    from test_torch_serve_dp import CLI, _cli
    argv = [a if a != "1" or CLI[i - 1] != "--pool-model-parallel"
            else str(mp) for i, a in enumerate(CLI)]
    argv += ["--arch", "olmoe-1b-7b", "--device", "cpu"]
    (rc1, out1, err1), (rc2, out2, err2) = _cli(
        [sys.executable, "-m", "repro_torch.launch.serve"] + argv,
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve"] + argv)
    assert rc1 == 0, err1
    assert rc2 == 0, err2
    one, two = json.loads(out1), json.loads(out2)
    assert two.pop("world") == 2
    assert two.pop("mesh") == {"data": 2 // mp, "model": mp}
    assert two.pop("ranks_agree") is True
    for d in (one, two):
        d.pop("wall_s")
    assert two == one
    assert one["arch"] == "olmoe-1b-7b-smoke"
