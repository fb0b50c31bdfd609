"""Tenants of one lease under a ``model`` axis, and the serving CLI's
fixed-batch and tenants modes across ranks.

Two tenants of one ``(data 1, model m)`` lease, each an
``Engine.from_lease(..., arbiter=, tenant=)`` over one ``PoolArbiter`` a
rank, on m = 2 and 4 ranks over gloo (``tests/_dist_world.py``, one
thread a rank), serve qwen1.5-0.5b smoke in fp32 from the reference's
parameters (through numpy): tenant ``a`` a burst of 8 requests, ``b`` 2
arriving at 1e-4 s, over a 6-page pool of 8-token pages, which makes
``b``'s arrival revoke ``a``'s pages.  They are held to the reference's
local two-tenant run (``Engine.local(..., arbiter=)`` with each tenant's
``kv_share`` of the same lease, ``run_multi_trace``; its own lease path
stops at C-ref1):

* tokens, every handle's clocks, each engine's stats and the arbiter's
  ``==`` the reference's on every rank, the pages checked after every
  engine step;
* the port's ``tracediff`` finds no divergence from the reference's
  trace, and the port's sanitizer passes every rank's;
* both tenants serve on the one grid the first joined, and each rank's
  pool holds its kv heads: layer 0 equal in bits to that slice of the
  one-process port run's pool, the later layer within 1e-5; its page
  bytes stay the whole model's.

The CLIs under ``torch.distributed.run``: the fixed-batch mode on 4
ranks (the smoke layout (data 2, model 2)) and ``--tenants 2`` on a
2-rank lease print the one-process CLI's summary, with ``ranks_agree``.
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
RUN = dict(slots=3, max_seq=64, page_size=8, pool_pages=6, kv_gb=1.0)
WORLDS = (2, 4)
LATER_LAYERS_TOL = 1e-5
TENANTS = ("a", "b")
BATCH_CLI = ["--smoke", "--batch", "8", "--prompt", "16", "--generate", "6"]
TENANTS_CLI = ["--smoke", "--requests", "12", "--max-new", "40", "--slots",
               "3", "--max-seq", "96", "--page-size", "16", "--tier1-pages",
               "12", "--prompt-lens", "32,16", "--interarrival", "0.0002",
               "--tier2-kv-gb", "1", "--tenants", "2", "--pool", "scalepool",
               "--pool-accels", "2", "--pool-model-parallel", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traces(module):
    """{tenant: requests} of ``module`` (``repro.serve`` or
    ``repro_torch.serve``): a burst for ``a``, a late pair for ``b``."""
    a = module.burst_trace(8, prompt_len=12, max_new_tokens=16,
                           vocab=VOCAB, seed=1)
    b = [dataclasses.replace(r, arrival_time=1e-4)
         for r in module.burst_trace(2, prompt_len=12, max_new_tokens=4,
                                     vocab=VOCAB, seed=2)]
    return {"a": a, "b": b}


def _reference(params_np):
    """The reference's local two-tenant run, traced."""
    cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32")
    model = ref_build(cfg)
    params = jax.tree.map(jax.numpy.asarray, params_np)
    lease = ref_smoke_pool("scalepool").lease(
        "tenants-tp", 2, tier2_gb=64, kv_gb=RUN["kv_gb"], tenants=TENANTS)
    tracer = RefTracer(1 << 16)
    arb = ref_serve.PoolArbiter(RUN["pool_pages"],
                                page_size=RUN["page_size"], tracer=tracer)
    ecfg = ref_serve.EngineConfig(max_slots=RUN["slots"],
                                  max_seq=RUN["max_seq"],
                                  page_size=RUN["page_size"])
    engines = [ref_serve.Engine.local(
        model, ecfg, params=params, arbiter=arb, tenant=n, tracer=tracer,
        budget=lease.kv_share(n, page_size=RUN["page_size"]))
        for n in TENANTS]
    traces = _traces(ref_serve)
    lists = ref_serve.run_multi_trace([(e, traces[n])
                                       for e, n in zip(engines, TENANTS)])
    return {"tokens": [[h.tokens for h in hs] for hs in lists],
            "clocks": [[(h.submit_clock, h.first_token_clock, h.done_clock)
                        for h in hs] for hs in lists],
            "stats": [e.stats() for e in engines], "arbiter": arb.stats(),
            "trace": ref_chrome(tracer)}


def _one_process_pool(params_np):
    """The port's one-process two-tenant run on the same lease: its
    arbiter's pool."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = bridge.params_from_reference(params_np, "cpu")
    lease = smoke_pool("scalepool").lease(
        "tenants-tp", 2, tier2_gb=64, kv_gb=RUN["kv_gb"], tenants=TENANTS)
    arb = serve.PoolArbiter(RUN["pool_pages"], page_size=RUN["page_size"])
    ecfg = serve.EngineConfig(max_slots=RUN["slots"], max_seq=RUN["max_seq"],
                              page_size=RUN["page_size"])
    engines = [serve.Engine.from_lease(model, lease, ecfg, params=params,
                                       arbiter=arb, tenant=n, device="cpu")
               for n in TENANTS]
    traces = _traces(serve)
    serve.run_multi_trace([(e, traces[n]) for e, n in zip(engines, TENANTS)])
    return arb.pool


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once, beside the reference's run and the
    one-process port pool on the same parameters."""
    root = tmp_path_factory.mktemp("serve_tenants")
    cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype="float32")
    params_np = jax.tree.map(np.asarray,
                             ref_build(cfg).init(jax.random.PRNGKey(0)))
    traces = {n: [(list(r.prompt_tokens), r.max_new_tokens, r.arrival_time)
                  for r in rs] for n, rs in _traces(serve).items()}
    pending = {}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        for m in WORLDS:
            d = root / f"m{m}"
            d.mkdir()
            with open(d / "params.pkl", "wb") as f:
                pickle.dump(params_np, f)
            pending[m] = (d, pool.submit(run_world, m, "serve_tenants", d,
                                         vocab=VOCAB, traces=traces, **RUN))
        ref = _reference(params_np)
        one = _one_process_pool(params_np)
        out = {}
        for m, (d, done) in pending.items():
            done.result()
            out[m] = [load(d, "serve_tenants", r) for r in range(m)]
    return ref, one, out


@pytest.mark.parametrize("m", WORLDS)
def test_tenants_serve_the_reference_run(worlds, m):
    ref, _, ranks = worlds
    assert ref["arbiter"]["revoked_pages"] > 0, "no page was revoked"
    for rank in ranks[m]:
        assert rank["grid"]["mesh"] == {"data": 1, "model": m}
        assert rank["tokens"] == ref["tokens"]
        assert rank["clocks"] == ref["clocks"]
        assert rank["stats"] == ref["stats"]
        assert rank["arbiter"] == ref["arbiter"]
        assert rank["checked"] > 0


@pytest.mark.parametrize("m", WORLDS)
def test_tenant_traces_equal_the_reference_and_sanitize(worlds, m):
    ref, _, ranks = worlds
    for rank in ranks[m]:
        diff = analysis.diff_trace_docs(ref["trace"], rank["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(rank["trace"])
        assert report.ok, report.format()


@pytest.mark.parametrize("m", WORLDS)
def test_tenants_share_one_grid_and_each_rank_pool_holds_its_kv_heads(
        worlds, m):
    _, one, ranks = worlds
    for r, rank in enumerate(ranks[m]):
        assert rank["grids"] == [True, True]
        assert rank["page_bytes"] == ranks[m][0]["page_bytes"]
        for name, full in one.items():
            kv = full.shape[3] // m
            want = full[..., r * kv:(r + 1) * kv, :]
            got = rank["pool"][name]
            assert got.shape == want.shape
            assert torch.equal(got[0], want[0]), (name, r)
            top = float(want[1:].abs().max())
            assert float((got[1:] - want[1:]).abs().max()) <= \
                LATER_LAYERS_TOL * top, (name, r)


def test_arbiter_pool_is_the_rank_heads_and_whole_page_bytes(worlds):
    """The one-process pool holds every kv head; a rank's the m-th part,
    at the whole model's page bytes."""
    _, one, ranks = worlds
    cfg = SMOKE_ARCHS[ARCH]
    for m in WORLDS:
        for rank in ranks[m]:
            assert rank["pool"]["k"].shape[3] == cfg.n_kv_heads // m
    assert one["k"].shape[3] == cfg.n_kv_heads
    whole = (2 * cfg.n_layers * RUN["page_size"] * cfg.n_kv_heads
             * cfg.head_dim * 4)
    assert all(r["page_bytes"] == whole for m in WORLDS for r in ranks[m])


# ---------------------------------------------------------------------------
# the CLIs across ranks
# ---------------------------------------------------------------------------

def _cli(*cmds):
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


def _torchrun(n, argv):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n), "-m", "repro_torch.launch.serve"
            ] + argv + ["--device", "cpu"]


def _one(argv):
    return [sys.executable, "-m", "repro_torch.launch.serve"] + argv + [
        "--device", "cpu"]


@pytest.fixture(scope="module")
def clis():
    return dict(zip(("batch1", "batch4", "mt1", "mt2"), _cli(
        _one(BATCH_CLI), _torchrun(4, BATCH_CLI), _one(TENANTS_CLI),
        _torchrun(2, TENANTS_CLI))))


@pytest.mark.parametrize("mode,one,many,mesh", [
    ("batch", "batch1", "batch4", {"data": 2, "model": 2}),
    ("tenants", "mt1", "mt2", {"data": 1, "model": 2})])
def test_cli_across_ranks_prints_the_one_process_run(clis, mode, one, many,
                                                     mesh):
    (rc1, out1, err1), (rcn, outn, errn) = clis[one], clis[many]
    assert rc1 == 0, err1
    assert rcn == 0, errn
    a, b = json.loads(out1), json.loads(outn)
    assert b.pop("world") == (4 if mode == "batch" else 2)
    assert b.pop("mesh") == mesh
    assert b.pop("ranks_agree") is True
    for d in (a, b):
        for key in ("wall_s", "prefill_s", "decode_tok_per_s"):
            d.pop(key, None)
    assert b == a
    if mode == "tenants":
        assert a["arbiter"]["revoked_pages"] > 0
