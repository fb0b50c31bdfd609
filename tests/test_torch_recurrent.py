"""Port vs reference: the mamba2 (ssm) and zamba2 (hybrid) families
through the fixed-batch serving path, on the CPU.

The reference's ``model.init(PRNGKey(0))`` weights go through
``repro_torch.bridge``; the same numpy prompts go through
``repro.models`` (JAX on the CPU) and ``repro_torch.models`` (the
kernels' plain versions on the CPU).  ``prefill`` and ``decode`` logits
and every cache leaf must agree within 2e-4 in fp32 (the SSD tests'
tolerance, ``tests/test_kernels.py``: the chunked scan sums in another
order than the reference's associative scan) and 2e-2 in bf16.

In bf16 the logits are held against the reference as it runs, and the
logits and every cache leaf against the reference run op by op
(``jax.disable_jit``).  Compiled, XLA keeps fused chains of bf16 ops in
fp32 (excess precision), so the compiled reference's bf16 results differ
from its own op-by-op results by several bf16 ulps; the port rounds to
bf16 after every op, as the op-by-op reference does (ROADMAP C-port4).
Even so the SSD's fp32 sums, run in another order, flip a bf16 rounding
now and then, and over zamba2's seven layers a flip moves an activation
by a share of the ulp of the largest values beside it.  So a zamba2 bf16
cache leaf is held within 2e-2 or 2 bf16 ulps of its largest magnitude,
whichever is more; the test prints the bound it used for each leaf.
Greedy tokens of an 8-step generation through ``make_decode_step`` must
be identical in fp32; a mismatch reports the top-2 logit margin at the
divergent step (ROADMAP C-ref3)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.runtime import serve as ref_serve                  # noqa: E402
from repro_torch import bridge, kernels                       # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.runtime import serve as port_serve           # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
CASES = [(arch, compute) for arch in ("mamba2-780m", "zamba2-7b")
         for compute in ("float32", "bfloat16")]
B, S = 2, 20          # S = 2 chunks of 8 plus a ragged tail of 4


def _models(arch, compute):
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype=compute)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    ref = ref_build(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    params = port.load(bridge.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu"))
    return ref, ref_params, port, params


def _prompts(vocab, seed=0):
    return np.random.RandomState(seed).randint(
        1, vocab, size=(B, S)).astype(np.int32)


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def _bf16_ulp(x) -> float:
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


def _close_cache(got, want, tol, what, ulps=0):
    """Every leaf within ``tol``, or ``ulps`` bf16 ulps of the leaf's
    largest magnitude where that is more."""
    assert sorted(got) == sorted(want), what
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        w = np.asarray(want[name], np.float32)
        atol = max(tol, ulps * _bf16_ulp(np.abs(w).max())) if ulps else tol
        print(f"{what} cache {name}: atol {atol}")
        np.testing.assert_allclose(got[name].float().numpy(), w, atol=atol,
                                   rtol=tol,
                                   err_msg=f"{what} cache {name}, atol {atol}")


def _cache_ulps(arch, compute):
    return 2 if (arch, compute) == ("zamba2-7b", "bfloat16") else 0


@pytest.mark.parametrize("arch,compute", CASES)
def test_prefill_matches_reference(arch, compute):
    ref, ref_params, port, params = _models(arch, compute)
    tokens = _prompts(port.cfg.vocab)

    def ref_prefill():
        return ref.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                           ref.init_cache(B, S + 4, dtype=jnp.float32))

    want, want_cache = ref_prefill()
    kernels.reset_launch_counts()
    got, got_cache = port.prefill(
        params, {"tokens": torch.as_tensor(tokens, dtype=torch.long)},
        port.init_cache(B, S + 4, dtype=torch.float32))
    assert tuple(got.shape) == tuple(want.shape) == (B, 1, port.cfg.vocab)
    _close(got, want, TOL[compute], f"{arch} prefill logits")
    if compute == "bfloat16":
        with jax.disable_jit():
            want, want_cache = ref_prefill()
        _close(got, want, TOL[compute], f"{arch} prefill logits, op by op")
    _close_cache(got_cache, want_cache, TOL[compute], f"{arch} prefill",
                 _cache_ulps(arch, compute))
    assert sum(kernels.launch_counts().values()) == 0   # CPU: plain only


@pytest.mark.parametrize("arch,compute", CASES)
def test_decode_matches_reference(arch, compute):
    """One decode step from the reference's own post-prefill cache."""
    ref, ref_params, port, params = _models(arch, compute)
    tokens = _prompts(port.cfg.vocab, seed=1)
    _, cache = ref.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                           ref.init_cache(B, S + 4, dtype=jnp.float32))
    port_cache = bridge.pool_from_reference(
        jax.tree.map(np.asarray, cache), device="cpu")
    nxt = np.asarray([[3], [port.cfg.vocab - 1]], np.int32)

    def ref_decode():
        return ref.decode(ref_params, jnp.asarray(nxt), cache, jnp.int32(S))

    want, want_cache = ref_decode()
    got, got_cache = port.decode(params, torch.as_tensor(nxt,
                                                         dtype=torch.long),
                                 port_cache, S)
    assert tuple(got.shape) == (B, 1, port.cfg.vocab)
    _close(got, want, TOL[compute], f"{arch} decode logits")
    if compute == "bfloat16":
        with jax.disable_jit():
            want, want_cache = ref_decode()
        _close(got, want, TOL[compute], f"{arch} decode logits, op by op")
    _close_cache(got_cache, want_cache, TOL[compute], f"{arch} decode",
                 _cache_ulps(arch, compute))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_greedy_generation_tokens_identical(arch):
    """Prefill, then 8 greedy steps through each package's
    ``make_decode_step``: the tokens must be identical in fp32."""
    ref, ref_params, port, params = _models(arch, "float32")
    tokens = _prompts(port.cfg.vocab, seed=2)
    steps = 8
    cache = ref.init_cache(B, S + steps + 1, dtype=jnp.float32)
    logits, cache = jax.jit(ref_serve.make_prefill_step(ref))(
        ref_params, {"tokens": jnp.asarray(tokens)}, cache)
    carry = {"tokens": jnp.argmax(logits[:, -1:], -1).astype(jnp.int32),
             "cache": cache, "index": jnp.int32(S)}
    decode = jax.jit(ref_serve.make_decode_step(ref))
    want, want_logits = [np.asarray(carry["tokens"])], []
    for _ in range(steps):
        lg, carry = decode(ref_params, carry)
        want_logits.append(np.asarray(lg[:, -1]))
        want.append(np.asarray(carry["tokens"]))

    logits, pcache = port_serve.make_prefill_step(port)(
        params, {"tokens": torch.as_tensor(tokens, dtype=torch.long)},
        port.init_cache(B, S + steps + 1, dtype=torch.float32))
    pc = {"tokens": torch.argmax(logits[:, -1:], -1), "cache": pcache,
          "index": S}
    step = port_serve.make_decode_step(port)
    got = [pc["tokens"].numpy()]
    for _ in range(steps):
        _, pc = step(params, pc)
        got.append(pc["tokens"].numpy())
    assert pc["index"] == S + steps
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            lg = want_logits[i - 1] if i else np.asarray(logits[:, -1])
            top2 = np.sort(lg, axis=-1)[:, -2:]
            pytest.fail(f"{arch}: greedy tokens diverge at step {i}: "
                        f"port {g.ravel()} vs reference {w.ravel()}; "
                        f"reference top-2 logit margins "
                        f"{(top2[:, 1] - top2[:, 0]).tolist()}")


def test_bridge_unstacks_hybrid_groups_and_tail():
    ref, ref_params, port, params = _models("zamba2-7b", "float32")
    tree = jax.tree.map(np.asarray, ref_params)
    n_groups, per, tail = 2, 3, 1                  # 7 layers, every 3
    assert len(params["mamba_main"]) == n_groups
    assert all(len(g) == per for g in params["mamba_main"])
    assert len(params["mamba_tail"]) == tail
    for g in range(n_groups):
        for j in range(per):
            np.testing.assert_array_equal(
                params["mamba_main"][g][j]["in_proj"].numpy(),
                tree["mamba_main"]["in_proj"][g, j])
    np.testing.assert_array_equal(params["mamba_tail"][0]["A_log"].numpy(),
                                  tree["mamba_tail"]["A_log"][0])
    np.testing.assert_array_equal(
        params["shared_attn"]["attn"]["wq"].numpy(),
        tree["shared_attn"]["attn"]["wq"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_init_params_matches_reference_tree(arch):
    """The card draws its own weights: the same tree, shapes and dtypes
    as the reference's init, and its constant leaves (A_log, D) equal."""
    ref, ref_params, port, _ = _models(arch, "float32")
    want = bridge.params_from_reference(jax.tree.map(np.asarray, ref_params),
                                        device="cpu")
    mine = port.init(torch.Generator().manual_seed(0))

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            if path.endswith(("/A_log", "/D", "/dt_bias")):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

    walk(mine, want)


@pytest.mark.parametrize("step", ["block_fwd", "block_decode"])
def test_mamba2_block_bf16_dtypes_match_reference(step):
    """One bf16 block on the same inputs, beside an fp32 cache as the
    fixed-batch mode keeps it: bf16 A = -exp(A_log), the bf16 dt_bias
    added to fp32, the fp32 conv tail beside bf16 x, the state cast back
    to the cache's dtype.  Elementwise 2e-2, and the dtypes equal."""
    from repro.models import mamba2 as ref_m
    from repro.models import transformer as ref_t
    from repro_torch.models import mamba2

    ref, ref_params, port, params = _models("mamba2-780m", "bfloat16")
    cfg = port.cfg
    lp_ref = jax.tree.map(lambda a: a[1],
                          ref_t.cast_params(ref_params, ref.cfg)["layers"])
    rng = np.random.RandomState(4)
    S1 = 1 if step == "block_decode" else S
    u = jnp.asarray(rng.standard_normal((B, S1, cfg.d_model)), jnp.bfloat16)
    conv = rng.standard_normal((B, cfg.ssm_conv_width - 1,
                                mamba2.conv_channels(cfg))).astype(np.float32)
    ssd = rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state)).astype(np.float32)
    want, (wc, ws) = getattr(ref_m, step)(lp_ref, u, ref.cfg,
                                          conv_state=jnp.asarray(conv),
                                          ssd_state=jnp.asarray(ssd))
    got, (gc, gs) = getattr(mamba2, step)(
        params["layers"][1], bridge.to_tensor(np.asarray(u), "cpu"), cfg,
        conv_state=torch.as_tensor(conv), ssd_state=torch.as_tensor(ssd))
    for g, w, what in ((got, want, "out"), (gc, wc, "conv"),
                       (gs, ws, "state")):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), what
        _close(g, w, TOL["bfloat16"], f"{step} {what}")
