"""Port vs reference: the moe family (olmoe-1b-7b, mixtral-8x7b smoke) on
the CPU.

The expert layer: ``repro_torch.models.moe.moe_mlp_fwd`` against
``repro.models.moe.moe_mlp_fwd`` (jitted, JAX on the CPU) on the same
numpy inputs and bridged weights, over both smoke configs, fp32 and
bf16, capacity factor 1.25 (tokens dropped) and 16 (none dropped) and
several (B, S, groups) shapes, one of them not divisible into its groups
(the reference falls back to one group).  The routing (each token's
experts and each entry's keep bit) must equal the reference's, the aux
loss too (within fp32 rounding: its means sum in another order), and
the output must agree within 1e-5 in fp32 and **bit for bit** in bf16:
the port rounds where XLA does, and folds a token's k updates in the
order XLA's scatter-add adds them.

The model: ``prefill_at`` and ``decode_paged`` against the reference at
1e-5 in fp32 and 2e-2 in bf16 (in bf16 the K/V against the reference run
op by op, as ``tests/test_torch_recurrent.py`` holds them), with prompts
and lengths past mixtral smoke's 32-token window; the bridge's round trip of the moe tree; the
fixed-batch steps (8 greedy steps, tokens identical in fp32); and the
CLI's engine mode against the reference CLI on the reference's weights.
The engines' parity is ``tests/test_torch_moe_engine.py``."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
from jax import lax                                           # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.launch.serve import main as ref_main               # noqa: E402
from repro.models import moe as ref_moe                       # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.runtime import serve as ref_serve                  # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch import serve as port_cli              # noqa: E402
from repro_torch.models import moe                            # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.runtime import serve as port_serve           # noqa: E402

ARCHS = ("olmoe-1b-7b", "mixtral-8x7b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (B, S, groups): a prefill, a decode batch, two groups, a token count
# that two groups do not divide, and 4 decode rows, where mixtral smoke's
# capacity 4*2/4*1.25 = 2.5 rounds half to even (to 2); olmoe smoke's
# 8*2/8*1.25 = 2.5 does at (8, 1, 1)
SHAPES = [(1, 64, 1), (8, 1, 1), (4, 16, 2), (3, 5, 2), (4, 1, 1)]
HALF_TO_EVEN = {("olmoe-1b-7b", (8, 1, 1)), ("mixtral-8x7b", (4, 1, 1))}
# where capacity factor 1.25 drops tokens (every olmoe smoke shape too)
TIGHT = {("mixtral-8x7b", (4, 1, 1))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only contend with
    the other test workers' (several times slower under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, compute, **kw):
    return (dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype=compute,
                                **kw),
            dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=compute, **kw))


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _ref_routing(params, x, cfg, groups):
    """The reference layer's routing, restated from its own lines
    (``src/repro/models/moe.py:60-100``): each token's top-k experts and,
    per group, the keep bit of each entry of the sorted dispatch list."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = groups if (B * S) % groups == 0 else 1
    Tg = B * S // G
    logits = jnp.einsum("gtd,de->gte",
                        x.reshape(G, Tg, d).astype(jnp.float32),
                        params["router"])
    _, expert_idx = lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    capacity = int(max(1, round(Tg * k / E * cfg.capacity_factor)))
    keeps = []
    for g in range(G):
        flat_e = expert_idx[g].reshape(-1)
        sorted_e = flat_e[jnp.argsort(flat_e)]
        counts = jnp.bincount(flat_e, length=E)
        starts = jnp.cumsum(counts) - counts
        keeps.append(np.asarray(jnp.arange(Tg * k) - starts[sorted_e]
                                < capacity))
    return np.asarray(expert_idx), np.stack(keeps), capacity


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("cf", [1.25, 16.0])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_reference(arch, compute, cf, shape):
    ref_cfg, cfg = _cfgs(arch, compute, capacity_factor=cf)
    B, S, groups = shape
    ref_p = ref_moe.init_moe_mlp(jax.random.PRNGKey(1), ref_cfg,
                                 jnp.float32)
    ref_p = jax.tree.map(lambda w: w.astype(JDT[compute]), ref_p)
    x = jnp.asarray(np.random.RandomState(sum(shape)).randn(
        B, S, cfg.d_model).astype(np.float32)).astype(JDT[compute])
    want, want_aux = jax.jit(lambda p, x: ref_moe.moe_mlp_fwd(
        p, x, ref_cfg, groups=groups))(ref_p, x)
    params = {k: bridge.to_tensor(np.asarray(v), "cpu")
              for k, v in ref_p.items()}
    with moe.record_routing() as calls:
        got, aux = moe.moe_mlp_fwd(params, bridge.to_tensor(
            np.asarray(x), "cpu"), cfg, groups=groups)

    want_idx, want_keep, capacity = _ref_routing(ref_p, x, ref_cfg, groups)
    (call,) = calls
    assert np.array_equal(call["expert_idx"].numpy(), want_idx)
    assert np.array_equal(call["keep"].numpy(), want_keep)
    assert bool((call["gap"] >= 0).all())
    if cf == 1.25 and (arch, shape) in HALF_TO_EVEN:
        assert capacity == 2
    drops = int((~call["keep"]).sum())
    if cf == 16.0:
        assert drops == 0
    elif (arch, shape) in TIGHT or arch == "olmoe-1b-7b":
        assert drops > 0, "the capacity is tight here: tokens must drop"
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert got.dtype == torch.float32 if compute == "float32" \
        else got.dtype == torch.bfloat16
    if compute == "bfloat16":
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32)), \
            "bf16 expert layer not bitwise equal to the reference's"
    else:
        _close(got, want, 1e-5, f"{arch} moe out")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _models(arch, compute):
    ref_cfg, cfg = _cfgs(arch, compute)
    ref = ref_build(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    params = port.load(bridge.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu"))
    return ref, ref_params, port, params


CASES = [(a, c) for a in ARCHS for c in ("float32", "bfloat16")]


def _op_by_op(compute, run, got, want_cache, what):
    """In bf16 the logits are also held against the reference run op by
    op (``jax.disable_jit``), and the cache only against that run: the
    compiled reference keeps fused chains of bf16 ops in fp32 (ROADMAP
    C-port4), so its K/V after a layer sit a few bf16 ulps from its own
    op-by-op ones, which the port rounds as.  Returns the cache to hold
    the port's against."""
    if compute != "bfloat16":
        return want_cache
    with jax.disable_jit():
        want, want_cache = run()
    _close(got, want, TOL[compute], f"{what} logits, op by op")
    return want_cache


@pytest.mark.parametrize("arch,compute", CASES)
def test_prefill_at_matches_reference(arch, compute):
    """A right-padded 48-token bucket with 40 real tokens: past mixtral
    smoke's 32-token window, and the padded tail competes for capacity."""
    ref, ref_params, port, params = _models(arch, compute)
    S, plen = 48, 40
    tokens = np.zeros((1, S), np.int32)
    tokens[0, :plen] = np.random.RandomState(0).randint(
        1, port.cfg.vocab, size=plen)

    def ref_prefill():
        return ref.prefill_at(
            ref_params, {"tokens": jnp.asarray(tokens)},
            ref.init_cache(1, S, dtype=jnp.float32), jnp.int32(plen - 1))

    want, want_cache = ref_prefill()
    got, got_cache = port.prefill_at(
        params, {"tokens": torch.as_tensor(tokens, dtype=torch.long)},
        port.init_cache(1, S, dtype=torch.float32), plen - 1)
    assert tuple(got.shape) == tuple(want.shape) == (1, 1, port.cfg.vocab)
    _close(got, want, TOL[compute], f"{arch} prefill logits")
    want_cache = _op_by_op(compute, ref_prefill, got, want_cache,
                           f"{arch} prefill")
    for name in ("k", "v"):
        _close(got_cache[name][:, :, :plen],
               np.asarray(want_cache[name])[:, :, :plen], TOL[compute],
               f"{arch} prefill cache {name}")
    if port.cfg.sliding_window:
        # the window masks here: without it the logits move
        wide = build_model(dataclasses.replace(port.cfg,
                                               sliding_window=None),
                           device="cpu")
        unmasked, _ = wide.prefill_at(
            params, {"tokens": torch.as_tensor(tokens, dtype=torch.long)},
            wide.init_cache(1, S, dtype=torch.float32), plen - 1)
        assert float((unmasked - got).abs().max()) > TOL[compute]


@pytest.mark.parametrize("arch,compute", CASES)
def test_decode_paged_matches_reference(arch, compute):
    ref, ref_params, port, params = _models(arch, compute)
    cfg = port.cfg
    rng = np.random.RandomState(1)
    B, ps, PMAX = 3, 16, 4
    P = B * PMAX + 1
    shape = (cfg.n_layers, P, ps, cfg.n_kv_heads, cfg.head_dim)
    pools = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    table = rng.permutation(P)[:B * PMAX].reshape(B, PMAX).astype(np.int32)
    lengths = np.asarray([1, 37, PMAX * ps - 1], np.int32)   # window 32
    tokens = rng.randint(1, cfg.vocab, size=(B, 1)).astype(np.int32)

    def ref_decode():
        return ref.decode_paged(
            ref_params, jnp.asarray(tokens),
            {n: jnp.asarray(v) for n, v in pools.items()},
            jnp.asarray(table), jnp.asarray(lengths))

    want, want_pools = ref_decode()
    with moe.record_routing() as calls:
        got, got_pools = port.decode_paged(
            params, torch.as_tensor(tokens, dtype=torch.long),
            bridge.pool_from_reference(pools, device="cpu"),
            torch.as_tensor(table), torch.as_tensor(lengths))
    assert len(calls) == cfg.n_layers
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    _close(got, want, TOL[compute], f"{arch} decode logits")
    want_pools = _op_by_op(compute, ref_decode, got, want_pools,
                           f"{arch} decode")
    for name in ("k", "v"):
        _close(got_pools[name], want_pools[name], TOL[compute],
               f"{arch} decode pool {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_of_the_moe_tree(arch):
    """The reference's stacked (L, E, d, f) expert leaves become one
    (E, d, f) leaf per layer, bit for bit, the fp32 router as it is; the
    port's own draw has the same tree, shapes and dtypes."""
    ref, ref_params, port, _ = _models(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, ref_params)
    params = bridge.params_from_reference(tree, device="cpu")
    cfg = port.cfg
    assert len(params["layers"]) == cfg.n_layers
    for i, layer in enumerate(params["layers"]):
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(layer["moe"][name].numpy(),
                                          tree["layers"]["moe"][name][i])
        assert layer["moe"]["router"].dtype == torch.float32
        assert tuple(layer["moe"]["w_down"].shape) == (
            cfg.n_experts, cfg.expert_d_ff, cfg.d_model)
    drawn = port.init(torch.Generator().manual_seed(0))

    def leaves(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tuple(t.shape), str(t.dtype)

    assert sorted(leaves(drawn)) == sorted(leaves(params))
    loaded = port.load(params)
    assert loaded["layers"][0]["moe"]["router"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_fixed_batch_steps_match_reference(arch):
    """Prefill, then 8 greedy steps through each package's
    ``make_decode_step`` in fp32: tokens identical, logits within 1e-5."""
    ref, ref_params, port, params = _models(arch, "float32")
    B, S, steps = 2, 40, 8
    tokens = np.random.RandomState(2).randint(
        1, port.cfg.vocab, size=(B, S)).astype(np.int32)
    cache = ref.init_cache(B, S + steps + 1, dtype=jnp.float32)
    logits, cache = jax.jit(ref_serve.make_prefill_step(ref))(
        ref_params, {"tokens": jnp.asarray(tokens)}, cache)
    carry = {"tokens": jnp.argmax(logits[:, -1:], -1).astype(jnp.int32),
             "cache": cache, "index": jnp.int32(S)}
    decode = jax.jit(ref_serve.make_decode_step(ref))
    want, want_logits = [np.asarray(carry["tokens"])], []
    for _ in range(steps):
        lg, carry = decode(ref_params, carry)
        want_logits.append(np.asarray(lg))
        want.append(np.asarray(carry["tokens"]))

    plog, pcache = port_serve.make_prefill_step(port)(
        params, {"tokens": torch.as_tensor(tokens, dtype=torch.long)},
        port.init_cache(B, S + steps + 1, dtype=torch.float32))
    _close(plog, logits, 1e-5, f"{arch} prefill logits")
    pc = {"tokens": torch.argmax(plog[:, -1:], -1), "cache": pcache,
          "index": S}
    step = port_serve.make_decode_step(port)
    got = [pc["tokens"].numpy()]
    for i in range(steps):
        lg, pc = step(params, pc)
        _close(lg, want_logits[i], 1e-5, f"{arch} decode {i} logits")
        got.append(pc["tokens"].numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), f"{arch}: tokens diverge at step {i}"


# ---------------------------------------------------------------------------
# the CLI's engine mode against the reference CLI
# ---------------------------------------------------------------------------

ENGINE_ARGS = ["--arch", "olmoe-1b-7b", "--smoke", "--requests", "6",
               "--max-new", "8", "--slots", "4", "--max-seq", "96",
               "--tier1-pages", "16", "--tier2-kv-gb", "1"]


def test_cli_engine_mode_matches_reference(capsys, monkeypatch):
    """``repro_torch.launch.serve`` on olmoe smoke, on the CPU, serving
    the reference CLI's weights (``model.init(PRNGKey(0))`` bridged):
    the reference CLI's JSON, sample tokens included, plus ``device``."""
    ref_params = ref_build(SMOKE_ARCHS["olmoe-1b-7b"]).init(
        jax.random.PRNGKey(0))
    bridged = bridge.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu")

    def build(cfg, **kw):
        model = build_model(cfg, **kw)
        return dataclasses.replace(model,
                                   init=lambda generator=None: bridged)

    monkeypatch.setattr(port_cli, "build_model", build)
    rc = port_cli.main(ENGINE_ARGS + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    ref_rc = ref_main(ENGINE_ARGS)
    ref_out = json.loads(capsys.readouterr().out)
    assert rc == ref_rc == 0
    assert out.pop("device") == "cpu" and out["mode"] == "engine"
    out.pop("wall_s"), ref_out.pop("wall_s")
    assert out["stats"]["completed"] == 6
    assert len(out["sample_tokens"]) == 8
    assert out == ref_out
