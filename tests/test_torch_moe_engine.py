"""The moe family through the serving engines: the port's
``repro_torch.serve.Engine`` against the reference's ``repro.serve.Engine``.

olmoe-1b-7b and mixtral-8x7b smoke, at the fig7 serving shape that
``tests/test_torch_engine.py`` runs (6 slots, 16-token pages, a 20-page
tier-1 quota, 32-token prompts, 160 new tokens), compute in fp32, weights
through the bridge.  With a tier-2 budget the quota forces pause, spill
and fetch; with none it forces drop and recompute.  Occupancy passes
through row buckets below 6 slots, so idle slots pad decode batches and
are routed too: under capacity drops a row's output depends on its
bucket (ROADMAP C-ref5), and the port must pad as the reference does.  Tokens, every handle's clocks and ``stats()`` must be
identical, the two Chrome traces must show no divergence under
``repro.analysis.tracediff`` and the port's trace must pass
``repro.analysis.sanitizer``.  A token mismatch reports the port's top-2
logit margin and smallest router gap there (ROADMAP C-ref3)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import serve as ref_serve                          # noqa: E402
from repro.analysis.sanitizer import sanitize_trace_doc       # noqa: E402
from repro.analysis.tracediff import diff_trace_docs          # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.obs import Tracer as RefTracer                     # noqa: E402
from repro.obs import to_chrome_trace as ref_chrome           # noqa: E402
from repro_torch import bridge, serve                         # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models import moe                            # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.obs import Tracer, to_chrome_trace           # noqa: E402

PAGE, PROMPT, MAX_NEW, SLOTS, QUOTA = 16, 32, 160, 6, 20
N_REQUESTS, INTERARRIVAL_S = 10, 0.008


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only contend with
    the other test workers' (several times slower under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32")
    ref = ref_build(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    params = bridge.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref, ref_params, port, params


def _margins(port, params, prompt, generated, step):
    """The port's top-2 logit margin, and the smallest gap between a
    token's k-th and (k+1)-th router probability over every layer, where
    token ``step`` of a request is chosen (the request alone)."""
    seq = list(prompt) + list(generated[:step])
    tokens = torch.as_tensor([seq], dtype=torch.long)
    with moe.record_routing() as calls:
        logits, _ = port.prefill_at(params, {"tokens": tokens},
                                    port.init_cache(1, len(seq),
                                                    dtype=torch.float32),
                                    len(seq) - 1)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1]), min(float(c["gap"].min()) for c in calls)


@pytest.mark.parametrize("tier2_bytes", [1e9, 0.0],
                         ids=["spill_fetch", "drop_recompute"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_engine_matches_reference(arch, tier2_bytes):
    ref, ref_params, port, params = _models(arch)
    kw = dict(mean_interarrival_s=INTERARRIVAL_S, prompt_lens=(PROMPT,),
              max_new_tokens=MAX_NEW, vocab=port.cfg.vocab, seed=0)
    ref_trace = ref_serve.synthetic_trace(N_REQUESTS, **kw)
    trace = serve.synthetic_trace(N_REQUESTS, **kw)
    ecfg = dict(max_slots=SLOTS, max_seq=PROMPT + MAX_NEW, page_size=PAGE)
    ref_tracer, tracer = RefTracer(1 << 20), Tracer(1 << 20)
    ref_eng = ref_serve.Engine.local(
        ref, ref_serve.EngineConfig(**ecfg), params=ref_params,
        budget=ref_serve.KVBudget(QUOTA, tier2_bytes, PAGE),
        tracer=ref_tracer)
    eng = serve.Engine.local(
        port, serve.EngineConfig(**ecfg), params=params,
        budget=serve.KVBudget(QUOTA, tier2_bytes, PAGE), tracer=tracer,
        device="cpu")
    ref_handles = ref_serve.run_trace(ref_eng, ref_trace)
    handles = serve.run_trace(eng, trace)

    assert len(handles) == len(ref_handles) == N_REQUESTS
    for h, rh in zip(handles, ref_handles):
        if h.tokens != rh.tokens:
            i = next(j for j, (a, b) in enumerate(zip(h.tokens, rh.tokens))
                     if a != b)
            margin, gap = _margins(port, eng.params,
                                   h.request.prompt_tokens, h.tokens, i)
            pytest.fail(f"{arch} request {h.rid}: token {i} is "
                        f"{h.tokens[i]} in the port, {rh.tokens[i]} in the "
                        f"reference; the port's top-2 logit margin there "
                        f"is {margin:.3e}, its smallest router gap "
                        f"{gap:.3e}")
        assert (h.submit_clock, h.first_token_clock, h.done_clock) == \
            (rh.submit_clock, rh.first_token_clock, rh.done_clock)
        assert (h.status.value, h.preempts, h.swaps, h.recomputes) == \
            (rh.status.value, rh.preempts, rh.swaps, rh.recomputes)

    stats, ref_stats = eng.stats(), ref_eng.stats()
    assert stats == ref_stats
    assert stats["completed"] == N_REQUESTS and stats["failed_oom"] == 0
    if tier2_bytes:
        assert stats["kv"]["spills"] > 0 and stats["kv"]["fetches"] > 0
    else:
        assert stats["preempt_recomputes"] > 0
    # idle slots padded some decode batch (and were routed)
    assert min(eng._row_buckets_used) < SLOTS
    assert eng._row_buckets_used == ref_eng._row_buckets_used

    doc, ref_doc = to_chrome_trace(tracer), ref_chrome(ref_tracer)
    diff = diff_trace_docs(ref_doc, doc)
    assert diff.identical, diff.format()
    report = sanitize_trace_doc(doc)
    assert report.ok, report.format()


def test_moe_row_output_depends_on_its_bucket():
    """ROADMAP C-ref5, on both packages: under capacity drops a live
    row's decode output depends on the row bucket it is padded to, since
    the expert capacity grows with the bucket's rows.  Two live rows with
    the same token over the same pages choose the same experts: in a
    bucket of 2 (capacity 1) the second loses them, in a bucket of 8
    (capacity 2) it keeps them.  With an ample capacity factor the bucket
    does not matter."""
    rng = np.random.RandomState(3)
    outs = {}
    for cf in (1.25, 16.0):
        ref_cfg = dataclasses.replace(SMOKE_ARCHS["olmoe-1b-7b"],
                                      compute_dtype="float32",
                                      capacity_factor=cf)
        cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                                  compute_dtype="float32",
                                  capacity_factor=cf)
        ref = ref_build(ref_cfg)
        ref_params = ref.init(jax.random.PRNGKey(0))
        port = build_model(cfg, device="cpu")
        params = port.load(bridge.params_from_reference(
            jax.tree.map(np.asarray, ref_params), device="cpu"))
        shape = (cfg.n_layers, 5, PAGE, cfg.n_kv_heads, cfg.head_dim)
        pools = {n: rng.standard_normal(shape).astype(np.float32)
                 for n in "kv"}
        for B in (2, 8):
            tokens = np.asarray([[7], [7]] + [[9]] * (B - 2), np.int32)
            table = np.asarray([[0, 1, 2, 3]] * 2 + [[4] * 4] * (B - 2),
                               np.int32)
            lengths = np.asarray([5, 5] + [0] * (B - 2), np.int32)
            got, _ = port.decode_paged(
                params, torch.as_tensor(tokens, dtype=torch.long),
                bridge.pool_from_reference(pools, device="cpu"),
                torch.as_tensor(table), torch.as_tensor(lengths))
            want, _ = ref.decode_paged(
                ref_params, jax.numpy.asarray(tokens),
                {n: jax.numpy.asarray(v) for n, v in pools.items()},
                jax.numpy.asarray(table), jax.numpy.asarray(lengths))
            np.testing.assert_allclose(got[:2].numpy(),
                                       np.asarray(want)[:2], atol=1e-5,
                                       rtol=1e-5)
            outs[cf, B] = got[1].numpy()
    assert float(np.abs(outs[1.25, 2] - outs[1.25, 8]).max()) > 1e-2
    np.testing.assert_allclose(outs[16.0, 2], outs[16.0, 8], atol=1e-5,
                               rtol=1e-5)
