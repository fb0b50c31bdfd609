"""The port's pool and lease layer against the reference's.

``repro_torch.pool`` (inventory, allocator, lease) is a copy of the pure
Python ``repro.pool`` with the JAX mesh replaced by a ``LeaseBinding``
of devices: the same seeded churn of leases, gangs, resizes and releases
must give the same allocations, failures and ``metrics()`` in both.  The
lease-backed serving paths (``Engine.from_lease``, ``make_lease_session``,
the CLI's ``--pool``) are held against the reference's *local* paths with
the lease's budget, because the reference's own lease-backed engine fails
on this tree's jax (ROADMAP C-ref1)."""

import dataclasses
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import pool as ref_pool                            # noqa: E402
from repro import serve as ref_serve                          # noqa: E402
from repro.ckpt.elastic import resize_plan as ref_resize_plan  # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.launch.serve import main as ref_main               # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.runtime import serve as ref_rt                     # noqa: E402
from repro_torch import bridge, pool, serve                   # noqa: E402
from repro_torch.ckpt.elastic import resize_plan              # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch.serve import main                     # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.models.config import ShapeConfig             # noqa: E402
from repro_torch.runtime.serve import make_lease_session      # noqa: E402

ARCH = "qwen1.5-0.5b"
VOCAB = SMOKE_ARCHS[ARCH].vocab
GB = 1e9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only contend with
    the other test workers' (several times slower under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(x):
    """Dataclasses and containers -> plain comparable values (the two
    packages' classes differ, their contents must not)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _inventory(pkg, policy):
    return pkg.build_inventory(
        n_pods=4, pod_size=8, hbm_per_accel_gb=192.0,
        n_memory_nodes=(0 if policy == "baseline" else 2),
        memory_node_gb=1024.0, memory_node_gbps=40.0,
        tier2_trunk_gbps=60.0 if policy == "contention" else None,
        interconnect=policy)


def _churn(pkg, policy, seed, n_ops=60):
    """A seeded sequence of pool operations; returns what each did."""
    rng = random.Random(seed)
    rp = pkg.ResourcePool(_inventory(pkg, policy))
    log, live, gangs = [], [], []
    for i in range(n_ops):
        op = rng.choice(["lease"] * 4 + ["gang", "resize", "release",
                                         "release_gang"])
        try:
            if op == "lease":
                t2 = rng.choice([0.0, 8.0, 64.0, 700.0])
                kv = rng.choice([0.0, min(t2, 2.0)])
                tenants = (("a", "b") if kv > 0 and rng.random() < 0.4
                           else ())
                lease = rp.lease(f"j{i}", rng.randint(1, 14), tier2_gb=t2,
                                 kv_gb=kv, tier2_gbps=rng.choice([0.0, 15.0]),
                                 model_parallel=rng.choice([1, 2]),
                                 tenants=tenants)
                live.append(lease.job)
                out = (lease.allocation, lease.mesh_shape(8),
                       lease.tiering_policy(),
                       lease.kv_share("a") if tenants else None)
            elif op == "gang":
                g = rp.lease_gang(f"g{i}", {
                    "prefill": dict(n_accels=rng.randint(1, 8)),
                    "decode": dict(n_accels=rng.randint(1, 8), tier2_gb=8,
                                   kv_gb=1.0, tenants=("d0",))})
                gangs.append(f"g{i}")
                route = rp.handoff_route(g["prefill"], g["decode"])
                out = ({r: l.allocation for r, l in g.items()},
                       None if route is None
                       else [l.name for l in route.links])
            elif op == "resize" and live:
                job = rng.choice(live)
                new, plan = rp.resize(job, rng.choice([2, 4, 6, 8, 16]))
                out = (new.allocation, plan)
            elif op == "release" and live:
                job = live.pop(rng.randrange(len(live)))
                rp.release(job)
                out = job
            elif op == "release_gang" and gangs:
                rp.release_gang(gangs.pop(0))
                out = None
            else:
                out = "skip"
        except (RuntimeError, ValueError, KeyError) as e:
            out = (type(e).__name__, str(e))
        rp.alloc.check_conservation()
        log.append((op, _plain(out), _plain(rp.metrics())))
    return log


@pytest.mark.parametrize("policy", ["scalepool", "baseline", "contention"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_churn_matches_reference(policy, seed):
    got = _churn(pool, policy, seed)
    want = _churn(ref_pool, policy, seed)
    assert got == want
    kinds = {op for op, out, _ in got if out != "skip"}
    assert {"lease", "resize", "release"} <= kinds
    assert any(isinstance(out, list) and out and out[0] in
               ("RuntimeError", "AllocationError", "ValueError")
               for _, out, _ in got) or policy == "scalepool"


def test_lease_surface_matches_reference():
    a, b = pool.smoke_pool(), ref_pool.smoke_pool()
    for p in (a, b):
        p.lease("wide", 12, model_parallel=2)
        p.lease("mt", 4, tier2_gb=64, kv_gb=3.0, tenants=("x", "y", "z"))
    for name in ("wide", "mt"):
        la, lb = a.leases[name], b.leases[name]
        for n in (1, 2, 4, 8, 12):
            assert la.mesh_shape(n) == lb.mesh_shape(n)
        assert _plain(la.tiering_policy()) == _plain(lb.tiering_policy())
        assert _plain(la.kv_budget(page_size=16)) == \
            _plain(lb.kv_budget(page_size=16))
    la, lb = a.leases["mt"], b.leases["mt"]
    assert la.kv_shares() == lb.kv_shares()
    demands = {"x": 0.2e9, "y": 2.5e9}
    assert la.kv_shares(demands) == lb.kv_shares(demands)
    for t in ("x", "y", "z"):
        assert _plain(la.kv_share(t, page_size=16)) == \
            _plain(lb.kv_share(t, page_size=16))
        assert _plain(la.kv_share(t, demands=demands)) == \
            _plain(lb.kv_share(t, demands=demands))
    with pytest.raises(KeyError, match="ghost"):
        la.kv_share("ghost")
    with pytest.raises(ValueError, match="tenants"):
        a.leases["wide"].kv_share("x")
    for old, new, mp in ((8, 16, 2), (512, 384, 16), (16, 4, 4)):
        assert resize_plan(old, new, model_parallel=mp) == \
            ref_resize_plan(old, new, model_parallel=mp)
    with pytest.raises(ValueError, match="model parallelism"):
        resize_plan(8, 6, model_parallel=4)


def test_lease_materialize_binds_devices():
    lease = pool.smoke_pool().lease("wide", 12, tier2_gb=8, kv_gb=1,
                                    model_parallel=2)
    b = lease.materialize(["cpu"])
    assert b.devices == (torch.device("cpu"),) and b.device.type == "cpu"
    assert (b.shape, b.axes) == lease.mesh_shape(1)
    assert b.policy == lease.tiering_policy() and b.policy.kv_spill
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lease.materialize()


# ---------------------------------------------------------------------------
# lease-backed serving against the reference's local paths (C-ref1)
# ---------------------------------------------------------------------------

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


def _ecfg(S):
    return S.EngineConfig(max_slots=3, max_seq=64, page_size=8)


def _same_runs(handles, ref_handles, eng, ref_eng):
    assert [h.tokens for h in handles] == [h.tokens for h in ref_handles]
    assert [(h.submit_clock, h.first_token_clock, h.done_clock)
            for h in handles] == \
        [(h.submit_clock, h.first_token_clock, h.done_clock)
         for h in ref_handles]
    assert eng.stats() == ref_eng.stats()


def test_engine_from_lease_matches_reference_local(models):
    """A lease's KV grant becomes the engine's tier-2 budget: the port's
    lease-backed engine equals the reference's local engine given that
    budget (a tier-1 quota forces spill and fetch)."""
    ref, ref_params, port, params = models
    lease = pool.smoke_pool("scalepool").lease("serve-eng", 4, tier2_gb=64,
                                               kv_gb=1.0)
    tight = lease.kv_budget(page_size=8)
    trace = serve.burst_trace(5, prompt_len=12, max_new_tokens=10,
                              vocab=VOCAB, seed=0)
    eng = serve.Engine.from_lease(port, lease, _ecfg(serve), params=params,
                                  device="cpu")
    assert eng.budget.tier2_bytes == tight.tier2_bytes == 1e9
    assert eng.device.type == "cpu"
    ref_eng = ref_serve.Engine.local(
        ref, _ecfg(ref_serve), params=ref_params,
        budget=ref_serve.KVBudget(None, tight.tier2_bytes, 8))
    _same_runs(serve.run_trace(eng, trace),
               ref_serve.run_trace(ref_eng, trace), eng, ref_eng)

    # with a tier-1 quota passed alongside the lease: pressure, spills
    budget = serve.KVBudget(6, tight.tier2_bytes, 8)
    eng = serve.Engine.from_lease(port, lease, _ecfg(serve), params=params,
                                  budget=budget, device="cpu")
    ref_eng = ref_serve.Engine.local(
        ref, _ecfg(ref_serve), params=ref_params,
        budget=ref_serve.KVBudget(6, tight.tier2_bytes, 8))
    _same_runs(serve.run_trace(eng, trace),
               ref_serve.run_trace(ref_eng, trace), eng, ref_eng)
    assert eng.stats()["kv"]["spills"] > 0


def test_engines_from_one_lease_share_arbiter_pool(models):
    """Two engines built from ONE multi-tenant lease and one arbiter take
    ``lease.kv_share(t)`` each and serve from one physical pool, as the
    reference's local engines with those budgets do."""
    ref, ref_params, port, params = models
    lease = pool.smoke_pool().lease("mt", 4, tier2_gb=64, kv_gb=4,
                                    tenants=("a", "b"))
    arb = serve.PoolArbiter(10, page_size=8)
    engs = [serve.Engine.from_lease(port, lease, _ecfg(serve), params=params,
                                    arbiter=arb, tenant=t, device="cpu")
            for t in ("a", "b")]
    assert [e.budget.tier2_bytes for e in engs] == [2 * GB, 2 * GB]
    assert arb.tenants == ("a", "b")
    with pytest.raises(KeyError, match="ghost"):
        serve.Engine.from_lease(port, lease, _ecfg(serve), params=params,
                                arbiter=arb, tenant="ghost", device="cpu")
    ref_arb = ref_serve.PoolArbiter(10, page_size=8)
    ref_engs = [ref_serve.Engine.local(
        ref, _ecfg(ref_serve), params=ref_params, arbiter=ref_arb, tenant=t,
        budget=ref_serve.KVBudget(None, lease.kv_share(t).tier2_bytes, 8))
        for t in ("a", "b")]
    traces = [serve.burst_trace(3, prompt_len=12, max_new_tokens=10,
                                vocab=VOCAB, seed=7 + i) for i in range(2)]
    got = serve.run_multi_trace(list(zip(engs, traces)))
    want = ref_serve.run_multi_trace(list(zip(ref_engs, traces)))
    for hs, rhs, e, re_ in zip(got, want, engs, ref_engs):
        _same_runs(hs, rhs, e, re_)
    assert arb.stats() == ref_arb.stats()
    assert arb.revoked_pages > 0


def test_make_lease_session_steps_match_reference(models):
    ref, ref_params, port, params = models
    lease = pool.smoke_pool().lease("serve", 4, tier2_gb=64, kv_gb=8)
    shape = ShapeConfig("serve_smoke", "decode", 32, 2)
    sess = make_lease_session(port, shape, lease, device="cpu")
    assert sess.kv_spill and sess.device.type == "cpu"
    assert sess.shape == shape
    loaded = port.load(params)
    tokens = np.random.RandomState(0).randint(1, VOCAB, size=(2, 8))
    cache = port.init_cache(2, 32, dtype=torch.float32)
    logits, cache = sess.prefill_step(
        loaded, {"tokens": torch.as_tensor(tokens)}, cache)
    ref_cache = ref.init_cache(2, 32, dtype=jax.numpy.float32)
    ref_logits, ref_cache = ref_rt.make_prefill_step(ref)(
        ref_params, {"tokens": jax.numpy.asarray(tokens)}, ref_cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-5, rtol=1e-5)
    carry = {"tokens": torch.argmax(logits[:, -1:, :], dim=-1),
             "cache": cache, "index": 8}
    ref_carry = {"tokens": jax.numpy.argmax(ref_logits[:, -1:, :], -1)
                 .astype(jax.numpy.int32),
                 "cache": ref_cache, "index": jax.numpy.int32(8)}
    assert np.array_equal(carry["tokens"].numpy(),
                          np.asarray(ref_carry["tokens"]))
    decode, ref_decode = sess.decode_step, ref_rt.make_decode_step(ref)
    for _ in range(3):
        logits, carry = decode(loaded, carry)
        ref_logits, ref_carry = ref_decode(ref_params, ref_carry)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=1e-5, rtol=1e-5)
        assert np.array_equal(carry["tokens"].numpy(),
                              np.asarray(ref_carry["tokens"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(carry["cache"][name].numpy(),
                                   np.asarray(ref_carry["cache"][name]),
                                   atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="differs"):
        make_lease_session(build_model(get_config(ARCH, smoke=True),
                                       device="meta"), shape, lease,
                           device="cpu")


# ---------------------------------------------------------------------------
# the CLI's --tenants / --pool modes against the reference CLI
# ---------------------------------------------------------------------------

MT_ARGS = ["--smoke", "--requests", "12", "--max-new", "40", "--slots", "3",
           "--max-seq", "96", "--page-size", "16", "--tier1-pages", "16",
           "--prompt-lens", "32,16", "--interarrival", "0.0002",
           "--tier2-kv-gb", "1", "--tenants", "3"]


def _json(fn, argv, capsys):
    rc = fn(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_cli_tenants_matches_reference(capsys):
    rc, out = _json(main, MT_ARGS + ["--device", "cpu"], capsys)
    ref_rc, ref_out = _json(ref_main, MT_ARGS, capsys)
    assert rc == ref_rc == 0
    assert out.pop("device") == "cpu"
    out.pop("wall_s"), ref_out.pop("wall_s")
    assert out == ref_out
    assert out["mode"] == "multitenant" and out["arbiter"]["revoked_pages"] > 0


def test_cli_pool_modes_run(capsys):
    """``--pool`` with ``--tenants``: three tenants share one lease's KV
    grant; without ``--tenants`` the lease-backed engine equals the
    reference's local engine with the same budget, all but the sampled
    tokens (each package draws its own random weights)."""
    rc, out = _json(main, MT_ARGS + ["--pool", "scalepool", "--device",
                                     "cpu"], capsys)
    assert rc == 0 and out["mode"] == "multitenant"
    assert sum(t["requests"] for t in out["per_tenant"].values()) == 12
    assert main(MT_ARGS + ["--pool", "scalepool", "--tier2-kv-gb", "0",
                           "--device", "cpu"]) == 2
    capsys.readouterr()

    engine_args = ["--smoke", "--requests", "6", "--max-new", "24",
                   "--slots", "3", "--max-seq", "96", "--page-size", "16",
                   "--tier1-pages", "6", "--tier2-kv-gb", "1",
                   "--prompt-lens", "24", "--interarrival", "0.0001"]
    rc, out = _json(main, engine_args + ["--pool", "scalepool",
                                         "--pool-accels", "4", "--device",
                                         "cpu"], capsys)
    ref_rc, ref_out = _json(ref_main, engine_args, capsys)
    assert rc == ref_rc == 0 and out["lease"] == "scalepool"
    assert out["stats"]["kv"]["spills"] > 0
    for d in (out, ref_out):
        for key in ("wall_s", "sample_tokens", "lease", "device"):
            d.pop(key, None)
    assert out == ref_out
