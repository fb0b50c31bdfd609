"""The request-level engine on a lease whose ``data`` or ``pod`` axis is
over 1: each rank decodes its block of every decode bucket's rows on its
``model`` block of heads, the page pool replicated over the batch axes
and kept equal by one all-gather a step of the rows' new K/V and tokens.

Worlds over gloo (``tests/_dist_world.py``, one thread a rank) serve
qwen1.5-0.5b smoke (4 heads, 4 kv heads, 2 layers) in fp32 from the
reference's parameters (through numpy) with ``Engine.from_lease``:

* (data 2, model 1), 2 ranks: the engine with 4 slots, and with 3
  slots, which the data axis does not divide, so the rules leave
  ``batch`` unsharded and every rank decodes every row;
* (data 2, model 2), 4 ranks: the engine, and two tenants of one lease
  over one arbiter a rank;
* (pod 2, data 1, model 2), 4 ranks: a lease of 12 accelerators that
  spans two pods, the rows over ``pod``.

The trace (8 requests of 5-14 prompt tokens and 6-20 new, one at 0 and
seven at 3 ms, a 4-slot engine over 8 pages of 8 tokens) runs every row
bucket from 1 (a bucket of fewer rows than data blocks, so a padded
block) up to the slots, spills to tier 2 and fetches back, and pauses
rows that resume into another slot than they left.  Each case is held
to the reference's *local* engine (its lease path fails on this tree's
jax, ROADMAP C-ref1) on the same parameters and trace:

* tokens, every handle's clocks, the latency summary, ``stats()`` (its
  row buckets, the KV stats) and the arbiter's stats ``==`` the
  reference's, on every rank;
* the port's ``tracediff`` finds no divergence from the reference's
  trace, and the port's sanitizer passes every rank's;
* the ranks of one ``model`` index hold pools equal in bits (the trash
  page aside: idle rows' writes land there, block by block); against
  the rank's kv-head slice of the one-process port run's pool, layer 0
  equal in bits where every rank decodes every row and within 1e-6
  where a one-row block takes torch's matrix-vector path, the later
  layer within 1e-5;
* each ``decode_paged`` call got exactly the rank's block of its bucket,
  ceil(b / n) rows, the short blocks padded with rows of the trash page
  and length 0; one all-gather over the batch axes a decode step, and
  ``model``'s collectives as on (data 1, model m).

The CLI's ``--requests`` and ``--disagg`` modes on (data 2, model 1)
under ``torch.distributed.run --nproc-per-node 2`` print the one-process
CLI's summary, with ``ranks_agree``.
"""

import concurrent.futures
import dataclasses
import json
import os
import pickle
import subprocess
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
from _dist_world import ROOT, load, run_world                 # noqa: E402

from repro_torch import analysis, bridge, serve               # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.pool import smoke_pool                       # noqa: E402

ARCH = "qwen1.5-0.5b"
VOCAB = SMOKE_ARCHS[ARCH].vocab
RUN = dict(max_seq=64, page_size=8, tier2_bytes=1e9, kv_gb=1.0)
# (name, slots, tier-1 pages): the engine; 3 slots, which a data axis of
# 2 does not divide; two tenants over one 6-page arbiter pool
CASES = {"engine": ("engine", 4, 8), "no_batch": ("no_batch", 3, 8),
         "tenants": ("tenants", 4, 6)}
# world: (ranks, the lease's accelerators, model_parallel, mesh, cases)
WORLDS = {
    "data2_model1": (2, 2, 1, {"data": 2, "model": 1},
                     ("engine", "no_batch")),
    "data2_model2": (4, 4, 2, {"data": 2, "model": 2},
                     ("engine", "tenants")),
    "pod2_model2": (4, 12, 2, {"pod": 2, "data": 1, "model": 2},
                    ("engine",)),
}
RUNS = [(w, c) for w, spec in WORLDS.items() for c in spec[4]]
TENANTS = ("a", "b")
LATER_LAYERS_TOL = 1e-5
LAYER0_TOL = 1e-6               # a few fp32 ulps of layer 0's largest |K|
CLI = ["--smoke", "--requests", "10", "--max-new", "12", "--slots", "4",
       "--max-seq", "96", "--page-size", "16", "--tier1-pages", "8",
       "--tier2-kv-gb", "1", "--prompt-lens", "24,40",
       "--interarrival", "0.0001", "--pool", "scalepool",
       "--pool-accels", "2", "--pool-model-parallel", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(module):
    """The trace as ``module``'s (``repro.serve`` or ``repro_torch.serve``)
    requests: seeded prompts, one arriving alone at 0."""
    rng = np.random.RandomState(0)
    lens = (10, 6, 14, 9, 7, 12, 5, 11)
    new = (20, 12, 16, 10, 18, 8, 14, 6)
    return [module.Request(tuple(rng.randint(1, VOCAB, size=n).tolist()), m,
                           arrival_time=0.0 if i == 0 else 0.003)
            for i, (n, m) in enumerate(zip(lens, new))]


def _tenant_traces(module):
    """{tenant: requests}: a burst for ``a``, a late pair for ``b`` whose
    arrival revokes ``a``'s pages."""
    a = module.burst_trace(8, prompt_len=12, max_new_tokens=16,
                           vocab=VOCAB, seed=1)
    b = [dataclasses.replace(r, arrival_time=1e-4)
         for r in module.burst_trace(2, prompt_len=12, max_new_tokens=4,
                                     vocab=VOCAB, seed=2)]
    return {"a": a, "b": b}


def _rows(requests):
    return [(list(r.prompt_tokens), r.max_new_tokens, r.arrival_time)
            for r in requests]


def _outcome(lists, engines, arb, pool=None):
    return {"tokens": [[h.tokens for h in hs] for hs in lists],
            "clocks": [[(h.submit_clock, h.first_token_clock, h.done_clock)
                        for h in hs] for hs in lists],
            "stats": [e.stats() for e in engines],
            "arbiter": None if arb is None else arb.stats(), "pool": pool}


def _reference(case, params_np):
    """The reference's local run of ``case``, traced."""
    _, slots, pages = CASES[case]
    cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32")
    model = ref_build(cfg)
    params = jax.tree.map(jax.numpy.asarray, params_np)
    tracer = RefTracer(1 << 16)
    ecfg = ref_serve.EngineConfig(max_slots=slots, max_seq=RUN["max_seq"],
                                  page_size=RUN["page_size"])
    if case == "tenants":
        lease = ref_smoke_pool("scalepool").lease(
            "serve-dp-tenants", 4, tier2_gb=64, kv_gb=RUN["kv_gb"],
            tenants=TENANTS)
        arb = ref_serve.PoolArbiter(pages, page_size=RUN["page_size"],
                                    tracer=tracer)
        engines = [ref_serve.Engine.local(
            model, ecfg, params=params, arbiter=arb, tenant=t, tracer=tracer,
            budget=lease.kv_share(t, page_size=RUN["page_size"]))
            for t in TENANTS]
        traces = _tenant_traces(ref_serve)
        lists = ref_serve.run_multi_trace([(e, traces[t])
                                           for e, t in zip(engines, TENANTS)])
    else:
        arb = None
        engines = [ref_serve.Engine.local(
            model, ecfg, params=params, tracer=tracer,
            budget=ref_serve.KVBudget(pages, RUN["tier2_bytes"],
                                      RUN["page_size"]))]
        lists = [ref_serve.run_trace(engines[0], _requests(ref_serve))]
    out = _outcome(lists, engines, arb)
    out["latency"] = [ref_serve.latency_summary(hs) for hs in lists]
    out["trace"] = ref_chrome(tracer)
    return out


def _one_process(case, params_np):
    """The port's one-process run of ``case`` on the same parameters: its
    pool (every kv head)."""
    _, slots, pages = CASES[case]
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = bridge.params_from_reference(params_np, "cpu")
    ecfg = serve.EngineConfig(max_slots=slots, max_seq=RUN["max_seq"],
                              page_size=RUN["page_size"])
    if case == "tenants":
        lease = smoke_pool("scalepool").lease(
            "serve-dp-tenants", 4, tier2_gb=64, kv_gb=RUN["kv_gb"],
            tenants=TENANTS)
        arb = serve.PoolArbiter(pages, page_size=RUN["page_size"])
        engines = [serve.Engine.local(
            model, ecfg, params=params, arbiter=arb, tenant=t,
            budget=lease.kv_share(t, page_size=RUN["page_size"]),
            device="cpu") for t in TENANTS]
        traces = _tenant_traces(serve)
        serve.run_multi_trace([(e, traces[t])
                               for e, t in zip(engines, TENANTS)])
        return arb.pool
    eng = serve.Engine.local(
        model, ecfg, params=params, device="cpu",
        budget=serve.KVBudget(pages, RUN["tier2_bytes"], RUN["page_size"]))
    serve.run_trace(eng, _requests(serve))
    return eng._pool


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world at once, beside the reference's runs and the
    one-process port pools on the same parameters."""
    root = tmp_path_factory.mktemp("serve_dp")
    cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32")
    params_np = jax.tree.map(np.asarray,
                             ref_build(cfg).init(jax.random.PRNGKey(0)))
    tenant_rows = {t: _rows(rs) for t, rs in _tenant_traces(serve).items()}
    pending = {}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        for name, (n, accels, mp, _, cases) in WORLDS.items():
            d = root / name
            d.mkdir()
            with open(d / "params.pkl", "wb") as f:
                pickle.dump(params_np, f)
            pending[name] = (d, pool.submit(
                run_world, n, "serve_dp", d, vocab=VOCAB, accels=accels,
                model_parallel=mp, cases=[CASES[c] for c in cases],
                requests=_rows(_requests(serve)),
                tenant_traces=tenant_rows, **RUN))
        refs = {c: _reference(c, params_np) for c in CASES}
        ones = {c: _one_process(c, params_np) for c in CASES}
        out = {}
        for name, (d, done) in pending.items():
            done.result()
            out[name] = [load(d, "serve_dp", r)
                         for r in range(WORLDS[name][0])]
    return refs, ones, out


def _decode_buckets(trace, track="engine"):
    """The bucket of each decode span of ``trace``'s ``track``."""
    names = {(e["pid"], e["tid"]): e["args"]["name"]
             for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    return [e["args"]["bucket"] for e in trace["traceEvents"]
            if e.get("name") == "decode" and e.get("ph") == "X"
            and names.get((e["pid"], e["tid"])) == track]


def test_the_trace_runs_every_bucket_spills_and_moves_slots(worlds):
    """The reference's run pads a bucket (1 row, 2 data blocks), runs
    every row bucket, spills and fetches, and a paused row resumes into
    another slot (the port's, which equals it in every event)."""
    refs, _, ranks = worlds
    ref = refs["engine"]
    kv = ref["stats"][0]["kv"]
    assert kv["spills"] > 0 < kv["fetches"]
    assert ref["stats"][0]["preempts"] > 0
    assert set(_decode_buckets(ref["trace"])) == {1, 2, 4}
    placed = ranks["data2_model2"][0]["engine"]["placed"][0]
    assert any(len(set(slots)) > 1 for slots in placed.values()), placed
    assert refs["tenants"]["arbiter"]["revoked_pages"] > 0


@pytest.mark.parametrize("world,case", RUNS)
def test_every_rank_serves_the_reference_run(worlds, world, case):
    """Tokens, clocks, latency, stats (row buckets, KV stats) and the
    arbiter's stats ``==`` the reference's local run on every rank."""
    refs, _, ranks = worlds
    ref = refs[case]
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
        assert rank[case]["dropped"] == 0
        diff = analysis.diff_trace_docs(refs[case]["trace"],
                                        rank[case]["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(rank[case]["trace"])
        assert report.ok, report.format()


@pytest.mark.parametrize("world,case", RUNS)
def test_replicas_hold_one_pool_of_their_kv_heads(worlds, world, case):
    """The ranks of one ``model`` index hold the same pool in bits.
    Against the rank's kv-head slice of the one-process pool: where
    every rank decodes every row (``no_batch``) layer 0 is equal in
    bits; where a rank decodes a block, a block of one row (a bucket of
    2 over 2 ranks) takes torch's one-row matrix-vector path on the
    CPU, whose sums part from the 2-row product's in the last bits, so
    layer 0 is held within ``LAYER0_TOL``; the later layer within 1e-5
    (attention and the MLP also sum over ``model`` in another order).
    The trash page is left out: idle rows write it, each rank those of
    its block."""
    _, ones, ranks = worlds
    m = WORLDS[world][3]["model"]
    by_model = {}
    for rank in ranks[world]:
        got = rank[case]
        lo, hi = got["kv_heads"]
        trash = got["trash"]
        for name, full in ones[case].items():
            want = full[:, :trash, ..., lo:hi, :]
            mine = got["pool"][name][:, :trash]
            assert mine.shape == want.shape
            assert hi - lo == full.shape[3] // m
            if case == "no_batch":
                assert torch.equal(mine[0], want[0]), (name, rank["grid"])
            top = float(want[0].abs().max())
            assert float((mine[0] - want[0]).abs().max()) <= \
                LAYER0_TOL * top, name
            top = float(want[1:].abs().max())
            assert float((mine[1:] - want[1:]).abs().max()) <= \
                LATER_LAYERS_TOL * top, name
            first = by_model.setdefault((lo, name), mine)
            assert torch.equal(mine, first), (name, rank["grid"])


@pytest.mark.parametrize("world,case", RUNS)
def test_each_rank_decodes_its_block_of_every_bucket(worlds, world, case):
    """Every ``decode_paged`` call of a rank got ceil(b / n) rows of the
    b-row bucket (n the ranks of the batch axes; every row where the
    rules leave ``batch`` unsharded); the blocks in the ranks' order are
    the bucket followed by padding rows of the trash page and length
    0, and the ranks of one block index got the same rows."""
    refs, _, ranks = worlds
    ranks = ranks[world]
    got0 = ranks[0][case]
    axes = got0["batch_axes"]
    n = 1
    for a in axes:
        n *= WORLDS[world][3][a]
    if case == "no_batch":
        assert got0["rules_batch"] is None and axes == ()
    else:
        assert n == 2 and got0["rules_batch"] is not None
    for e, track in enumerate(["engine"] if case != "tenants" else
                              [f"engine:{t}" for t in TENANTS]):
        buckets = _decode_buckets(refs[case]["trace"], track)
        blocks = {}
        for rank in ranks:
            calls = rank[case]["calls"][e]
            assert [c[0] for c in calls] == [-(-b // n) for b in buckets]
            index = 0
            for a in axes:
                index = index * WORLDS[world][3][a] + \
                    rank["grid"]["coords"][a]
            seen = blocks.setdefault(index, calls)
            assert seen == calls
        trash = ranks[0][case]["trash"]
        for k, b in enumerate(buckets):
            rows = [x for i in range(n) for x in zip(blocks[i][k][1],
                                                     blocks[i][k][2])]
            assert len(rows) == n * -(-b // n)
            assert all(r == (0, trash) for r in rows[b:]), rows


@pytest.mark.parametrize("world,case", RUNS)
def test_one_gather_a_decode_step_over_the_batch_axes(worlds, world, case):
    """Each decode step: one all-gather over the batch axes (the rows'
    K/V and tokens), none where ``batch`` is unsharded; under ``model``
    each model call's all-reduces (the lookup, attention and the MLP of
    each layer) and the argmax's all-gather."""
    refs, _, ranks = worlds
    names = [e["name"] for e in refs[case]["trace"]["traceEvents"]]
    decodes, prefills = names.count("decode"), names.count("prefill")
    mesh = WORLDS[world][3]
    layers = SMOKE_ARCHS[ARCH].n_layers
    want = {}
    axes = ranks[world][0][case]["batch_axes"]
    if axes:
        want["+".join(axes) + ":all-gather"] = decodes
    if mesh["model"] > 1:
        want["model:all-reduce"] = (decodes + prefills) * (1 + 2 * layers)
        want["model:all-gather"] = decodes + prefills
    for rank in ranks[world]:
        assert rank[case]["collectives"] == want


# ---------------------------------------------------------------------------
# the CLI across two ranks on (data 2, model 1)
# ---------------------------------------------------------------------------

def _cli(*cmds):
    """Each command run at once; their (exit code, stdout, stderr)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT), env=env) for c in cmds]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


@pytest.mark.parametrize("mode", [[], ["--disagg"]], ids=["engine",
                                                         "disagg"])
def test_cli_across_two_ranks_prints_the_one_process_run(mode):
    argv = CLI + mode + ["--device", "cpu"]
    (rc1, out1, err1), (rc2, out2, err2) = _cli(
        [sys.executable, "-m", "repro_torch.launch.serve"] + argv,
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve"] + argv)
    assert rc1 == 0, err1
    assert rc2 == 0, err2
    one, two = json.loads(out1), json.loads(out2)
    assert two.pop("world") == 2
    assert two.pop("mesh") == {"data": 2, "model": 1}
    assert two.pop("ranks_agree") is True
    for d in (one, two):
        d.pop("wall_s")
    assert two == one
    if not mode:
        assert one["stats"]["kv"]["spills"] > 0
    else:
        assert one["handoffs"] > 0
