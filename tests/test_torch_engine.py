"""The slice as a whole: the port's serving engine vs the reference's.

The fig7 serving shape (qwen1.5-0.5b smoke, 6 slots, 16-token pages, a
20-page tier-1 quota, 32-token prompts, 160 new tokens) runs through
``repro.serve.Engine`` (JAX on the CPU) and ``repro_torch.serve.Engine``
(the kernels' plain versions on the CPU), compute in fp32 as the
reference's engine fixture sets it, weights through the bridge.  With a
tier-2 budget the quota forces pause, spill and fetch; with none it
forces drop + recompute.  Tokens, every handle's clocks and ``stats()``
must be identical, the two Chrome traces must show no divergence under
``repro.analysis.tracediff`` and the port's trace must pass
``repro.analysis.sanitizer``."""

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
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.obs import Tracer, to_chrome_trace           # noqa: E402

ARCH = "qwen1.5-0.5b"
PAGE, PROMPT, MAX_NEW, SLOTS, QUOTA = 16, 32, 160, 6, 20
N_REQUESTS, INTERARRIVAL_S = 10, 0.008


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


def _top2_margin(port, params, prompt, generated, step):
    """Top-2 logit margin of the port's model where token ``step`` of a
    request is chosen (ROADMAP C-ref3: a near-tie is a documented
    accumulation-order flip, anything larger a port fault)."""
    seq = list(prompt) + list(generated[:step])
    tokens = torch.as_tensor([seq], dtype=torch.long)
    logits, _ = port.prefill_at(params, {"tokens": tokens},
                                port.init_cache(1, len(seq),
                                                dtype=torch.float32),
                                len(seq) - 1)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("tier2_bytes", [1e9, 0.0],
                         ids=["spill_fetch", "drop_recompute"])
def test_engine_matches_reference_on_fig7_shape(models, tier2_bytes):
    ref, ref_params, port, params = models
    vocab = port.cfg.vocab
    kw = dict(mean_interarrival_s=INTERARRIVAL_S, prompt_lens=(PROMPT,),
              max_new_tokens=MAX_NEW, vocab=vocab, seed=0)
    ref_trace = ref_serve.synthetic_trace(N_REQUESTS, **kw)
    trace = serve.synthetic_trace(N_REQUESTS, **kw)
    assert [(r.prompt_tokens, r.arrival_time) for r in trace] == \
        [(r.prompt_tokens, r.arrival_time) for r in ref_trace]

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
            margin = _top2_margin(port, eng.params,
                                  h.request.prompt_tokens, h.tokens, i)
            pytest.fail(f"request {h.rid}: token {i} is {h.tokens[i]} in "
                        f"the port, {rh.tokens[i]} in the reference; the "
                        f"port's top-2 logit margin there is {margin:.3e}")
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

    doc, ref_doc = to_chrome_trace(tracer), ref_chrome(ref_tracer)
    diff = diff_trace_docs(ref_doc, doc)
    assert diff.identical, diff.format()
    report = sanitize_trace_doc(doc)
    assert report.ok, report.format()


def test_engine_pool_pages_match_reference_after_prefill(models):
    """Prefill writes only the real-token pages, in place, with the
    reference's contents (compared page by page through the table)."""
    ref, ref_params, port, params = models
    ecfg = dict(max_slots=2, max_seq=64, page_size=8)
    req = dict(prompt_tokens=tuple(range(1, 20)), max_new_tokens=3)
    ref_eng = ref_serve.Engine.local(ref, ref_serve.EngineConfig(**ecfg),
                                     params=ref_params)
    eng = serve.Engine.local(port, serve.EngineConfig(**ecfg), params=params,
                             device="cpu")
    ref_eng.submit(ref_serve.Request(**req))
    eng.submit(serve.Request(**req))
    ref_eng.step()
    eng.step()           # prefill + first decode step
    assert np.array_equal(eng._table, ref_eng._table)
    live = [int(p) for p in eng._table[0] if p != eng._trash][:3]
    for name in ("k", "v"):
        got = eng._pool[name][:, live].numpy()
        want = np.asarray(ref_eng._pool[name])[:, live]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
