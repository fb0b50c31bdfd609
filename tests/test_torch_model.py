"""Port vs reference: dense-transformer model math on the CPU.

The reference's ``model.init(PRNGKey(0))`` weights go through
``repro_torch.bridge``; the same numpy inputs go through
``repro.models`` (JAX on the CPU) and ``repro_torch.models`` (the
kernels' plain versions on the CPU).  ``prefill_at`` logits and its KV
cache, and ``decode_paged`` logits plus the updated ``{"k","v"}`` page
pools, must agree within 1e-5 in fp32 and 2e-2 in bf16 — the tolerances
of ``tests/test_kernels.py`` and ``tests/test_paged_attention.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402

# (arch, compute dtype, tolerance)
CASES = [
    ("qwen1.5-0.5b", "float32", 1e-5),          # qkv bias
    ("qwen3-14b", "float32", 1e-5),             # qk-norm, G = 5
    ("olmo-1b", "float32", 1e-5),               # non-parametric LN
    ("command-r-plus-104b", "float32", 1e-5),   # layernorm, parallel block
    ("qwen1.5-0.5b", "bfloat16", 2e-2),         # bf16 compute, fp32 KV
]


def _models(arch, compute):
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype=compute)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    ref = ref_build(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref_params)
    port = build_model(cfg, device="cpu")
    params = port.load(bridge.params_from_reference(tree, device="cpu"))
    return ref, ref_params, port, params


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("arch,compute,tol", CASES)
def test_prefill_at_matches_reference(arch, compute, tol):
    ref, ref_params, port, params = _models(arch, compute)
    rng = np.random.RandomState(0)
    S, plen = 16, 11                  # right-padded bucket, real length 11
    tokens = np.zeros((1, S), np.int32)
    tokens[0, :plen] = rng.randint(1, port.cfg.vocab, size=plen)

    cache = ref.init_cache(1, S, dtype=jnp.float32)
    want, want_cache = ref.prefill_at(ref_params,
                                      {"tokens": jnp.asarray(tokens)},
                                      cache, jnp.int32(plen - 1))
    got, got_cache = port.prefill_at(
        params, {"tokens": torch.as_tensor(tokens, dtype=torch.long)},
        port.init_cache(1, S, dtype=torch.float32), plen - 1)
    assert tuple(got.shape) == tuple(want.shape) == (1, 1, port.cfg.vocab)
    _close(got, want, tol, f"{arch} prefill logits")
    for name in ("k", "v"):
        # only the real positions matter: pad K/V is never read
        _close(got_cache[name][:, :, :plen],
               np.asarray(want_cache[name])[:, :, :plen], tol,
               f"{arch} prefill cache {name}")


@pytest.mark.parametrize("arch,compute,tol", CASES)
def test_decode_paged_matches_reference(arch, compute, tol):
    ref, ref_params, port, params = _models(arch, compute)
    cfg = port.cfg
    rng = np.random.RandomState(1)
    B, ps, PMAX = 3, 4, 4
    P = B * PMAX + 1
    shape = (cfg.n_layers, P, ps, cfg.n_kv_heads, cfg.head_dim)
    pools = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    # each row owns its own pages, so no two rows write one location
    table = rng.permutation(P)[:B * PMAX].reshape(B, PMAX).astype(np.int32)
    lengths = np.asarray([1, 7, PMAX * ps - 1], np.int32)
    tokens = rng.randint(1, cfg.vocab, size=(B, 1)).astype(np.int32)

    want, want_pools = ref.decode_paged(
        ref_params, jnp.asarray(tokens),
        {n: jnp.asarray(v) for n, v in pools.items()},
        jnp.asarray(table), jnp.asarray(lengths))
    got, got_pools = port.decode_paged(
        params, torch.as_tensor(tokens, dtype=torch.long),
        bridge.pool_from_reference(pools, device="cpu"),
        torch.as_tensor(table), torch.as_tensor(lengths))
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    _close(got, want, tol, f"{arch} decode logits")
    for name in ("k", "v"):
        _close(got_pools[name], want_pools[name], tol,
               f"{arch} decode pool {name}")


def test_bridge_unstacks_layers_and_keeps_bits():
    ref, ref_params, port, _ = _models("qwen1.5-0.5b", "float32")
    tree = jax.tree.map(np.asarray, ref_params)
    params = bridge.params_from_reference(tree, device="cpu")
    assert len(params["layers"]) == port.cfg.n_layers
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      tree["layers"]["attn"]["wq"][i])
    bf = np.asarray(jnp.asarray(tree["embedding"]["table"], jnp.bfloat16))
    back = bridge.to_tensor(bf, device="cpu")
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(),
                                  bf.astype(np.float32))


def test_init_params_matches_reference_shapes_and_scales():
    """The card run draws its own weights: same tree, shapes and dtypes
    as the reference's init, embedding std ~0.02, fan-in std ~1/sqrt(d)."""
    ref, ref_params, port, _ = _models("qwen3-14b", "float32")
    tree = jax.tree.map(np.asarray, ref_params)
    mine = port.init(torch.Generator().manual_seed(0))
    want = bridge.params_from_reference(tree, device="cpu")

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

    walk(mine, want)
    table = mine["embedding"]["table"]
    assert abs(float(table.std()) - 0.02) < 0.002
    wq = mine["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * wq.shape[0] ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("window", [None, 5])
def test_gqa_attention_matches_reference_and_flash_path(window):
    """The port's plain ``gqa_attention`` against the reference's, and the
    model's flash path against both (q at an offset into a longer cache,
    kv_len masking its tail)."""
    from repro.models.layers import gqa_attention as ref_gqa
    from repro_torch.kernels import ops
    from repro_torch.models.layers import gqa_attention

    rng = np.random.RandomState(2)
    q = rng.standard_normal((2, 9, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    kw = dict(causal=True, q_offset=7, sliding_window=window, kv_len=16)
    want = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    _close(gqa_attention(tq, tk, tv, **kw), want, 1e-5, "gqa")
    _close(ops.flash_attention(tq, tk, tv, **kw), want, 1e-5, "flash path")


@pytest.mark.parametrize("arch", ["qwen3-14b", "command-r-plus-104b"])
def test_forward_without_cache_matches_reference(arch):
    """``forward`` with no KV cache (causal attention over the sequence
    itself): final hidden states against the reference's."""
    from repro.models import transformer as ref_tf
    from repro_torch.models import transformer

    ref, ref_params, port, params = _models(arch, "float32")
    tokens = np.random.RandomState(3).randint(1, port.cfg.vocab,
                                              size=(2, 12)).astype(np.int32)
    want, _ = ref_tf.forward(ref_params, ref.cfg,
                             {"tokens": jnp.asarray(tokens)})
    got, _ = transformer.forward(
        params, port.cfg, {"tokens": torch.as_tensor(tokens,
                                                     dtype=torch.long)})
    _close(got, want, 1e-5, f"{arch} hidden states")
