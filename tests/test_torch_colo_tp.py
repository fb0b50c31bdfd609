"""Co-resident serving and training under a ``model``-axis lease.

fig11's hop-only run at its racecheck shape (4 requests a tenant, 4
training steps; ``chip_smoke.co_run``, which ``tests/test_torch_colo_fig11.py``
holds to fig11 on one process) on m = 2 and 4 ranks over gloo
(``tests/_dist_world.py``, one thread a rank): both tenants' engines are
``Engine.from_lease`` of one (data 1, model m) lease on one grid,
sharing one ``Transport`` with the training job's ``TrainActor`` through
``run_colo``, on qwen1.5-0.5b smoke in fp32 from the reference's
parameters (through numpy).  Held to the reference's ``run_colo`` over
``Engine.local`` (``test_torch_colo_fig11._ref_traced``), on every rank:

* tokens, latencies and p95s, every handle's clocks, the engines'
  clocks and stats, ``train_stats()``, ``link_report`` and
  ``Transport.stats()`` ``==`` the reference's;
* the port's ``tracediff`` finds no divergence from the reference's
  trace, and the port's sanitizer passes every rank's;
* both engines serve on one grid, each holding the rank's kv heads.
"""

import concurrent.futures
import dataclasses
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from benchmarks import fig11_colocation as fig11              # noqa: E402
from repro import serve as ref_serve                          # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import Tracer as RefTracer                     # noqa: E402
from repro.obs import to_chrome_trace as ref_chrome           # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import load, run_world                       # noqa: E402
from test_torch_colo_fig11 import (FULL_CFG, _clocks,          # noqa: E402
                                   _ref_traced, cs)

from repro_torch import analysis                              # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds at once, beside the reference's hop-only run on the
    same parameters."""
    root = tmp_path_factory.mktemp("serve_colo")
    cfg = dataclasses.replace(SMOKE_ARCHS[fig11.ARCH],
                              compute_dtype="float32")
    model = ref_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    pending = {}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        for m in WORLDS:
            d = root / f"m{m}"
            d.mkdir()
            with open(d / "params.pkl", "wb") as f:
                pickle.dump(params_np, f)
            pending[m] = (d, pool.submit(
                run_world, m, "serve_colo", d, vocab=cfg.vocab,
                n_requests=cs.CO_RACE_REQUESTS, n_steps=cs.CO_RACE_STEPS))
        probe = ref_serve.Engine.local(
            model, ref_serve.EngineConfig(
                max_slots=fig11.SLOTS, max_seq=fig11.PROMPT + fig11.MAX_NEW,
                page_size=fig11.PAGE),
            params=params,
            budget=ref_serve.KVBudget(fig11.QUOTA, 1e9, fig11.PAGE))
        bw = fig11._page_bw(FULL_CFG, probe.kv.page_bytes)
        traces = {t: ref_serve.burst_trace(
            cs.CO_RACE_REQUESTS, prompt_len=fig11.PROMPT,
            max_new_tokens=fig11.MAX_NEW, vocab=cfg.vocab, seed=i)
            for i, t in enumerate(fig11.TENANTS)}
        tracer = RefTracer(1 << 18)
        ref = _ref_traced("scalepool", model, params, traces, bw,
                          cs.CO_RACE_STEPS, tracer)
        assert tracer.dropped == 0
        out = {}
        for m, (d, done) in pending.items():
            done.result()
            out[m] = [load(d, "serve_colo", r) for r in range(m)]
    return ref, ref_chrome(tracer), bw, out


@pytest.mark.parametrize("m", WORLDS)
def test_colo_serves_the_reference_run(worlds, m):
    ref, _, bw, ranks = worlds
    assert ref["transport"]["contended_transfers"] > 0
    assert ref["train"]["steps"] == cs.CO_RACE_STEPS
    for rank in ranks[m]:
        assert rank["bw"] == bw
        assert rank["outcome"] == cs.co_outcome(ref)
        assert rank["clocks"] == _clocks(ref)
        assert rank["engine_clocks"] == {t: e.clock for t, e
                                         in ref["engines"].items()}
        assert rank["stats"] == {t: e.stats() for t, e
                                 in ref["engines"].items()}


@pytest.mark.parametrize("m", WORLDS)
def test_colo_traces_equal_the_reference_and_sanitize(worlds, m):
    _, ref_trace, _, ranks = worlds
    for rank in ranks[m]:
        assert rank["dropped"] == 0
        diff = analysis.diff_trace_docs(ref_trace, rank["trace"])
        assert diff.identical, diff.format()
        report = analysis.sanitize_trace_doc(rank["trace"])
        assert report.ok, report.format()
        for rule in ("kv-conservation", "link-conservation",
                     "transfer-causality"):
            assert report.checks[rule] > 0, rule


@pytest.mark.parametrize("m", WORLDS)
def test_colo_engines_share_one_grid(worlds, m):
    _, _, _, ranks = worlds
    n_kv = SMOKE_ARCHS[fig11.ARCH].n_kv_heads // m
    for r, rank in enumerate(ranks[m]):
        assert rank["one_grid"]
        assert rank["mesh"] == {"data": 1, "model": m}
        assert rank["kv_heads"] == [(r * n_kv, (r + 1) * n_kv)] * 2
