"""Port kernels vs the reference's, on the CPU.

Each wrapper of ``repro_torch.kernels`` runs its plain PyTorch version
for a CPU tensor; it is held against the reference's Pallas kernel in
interpret mode and against ``repro.kernels.ref`` on the same numpy
inputs.  Tolerances are the reference suites': 1e-5 in fp32 and 2e-2 in
bf16 (``tests/test_paged_attention.py``, ``tests/test_kernels.py``).
The CUDA kernels themselves are tested on the card in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import ops as ref_ops                      # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro.kernels.paged_attention import paged_decode_attention as pallas_paged  # noqa: E402,E501
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm   # noqa: E402
from repro.models.layers import gqa_attention as jax_gqa      # noqa: E402
from repro_torch import kernels                               # noqa: E402
from repro_torch.bridge import to_tensor                      # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402,E501
from repro_torch.kernels.rmsnorm import rmsnorm               # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(arr, dtype):
    """The same values as a jnp array and a torch tensor (bits equal)."""
    j = jnp.asarray(arr, getattr(jnp, dtype))
    return j, to_tensor(np.asarray(j), device="cpu")


def _close(got, want, tol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_case(seed, *, B, KV, G, D, P, ps, PMAX, q_dtype, kv_dtype):
    rng = np.random.RandomState(seed)
    H = KV * G
    q = _pair(rng.standard_normal((B, H, D)), q_dtype)
    kp = _pair(rng.standard_normal((P, ps, KV, D)), kv_dtype)
    vp = _pair(rng.standard_normal((P, ps, KV, D)), kv_dtype)
    pt = rng.randint(0, P, size=(B, PMAX)).astype(np.int32)
    lengths = rng.randint(0, PMAX * ps + 1, size=(B,)).astype(np.int32)
    pt = (jnp.asarray(pt), torch.as_tensor(pt))
    lengths = (jnp.asarray(lengths), torch.as_tensor(lengths))
    return q, kp, vp, pt, lengths


def _paged_all(case, **kw):
    """(port plain, Pallas interpret, repro ref) on one case."""
    q, kp, vp, pt, ln = case
    got = paged_decode_attention(q[1], kp[1], vp[1], pt[1], ln[1], **kw)
    pallas = pallas_paged(q[0], kp[0], vp[0], pt[0], ln[0], interpret=True,
                          **kw)
    want = jref.paged_attention_ref(q[0], kp[0], vp[0], pt[0], ln[0], **kw)
    return got, pallas, want


@pytest.mark.parametrize("ps", [4, 8, 16])
def test_paged_matches_reference_across_page_sizes(ps):
    case = _paged_case(0, B=4, KV=2, G=2, D=16, P=9, ps=ps, PMAX=5,
                       q_dtype="float32", kv_dtype="float32")
    got, pallas, want = _paged_all(case)
    _close(got, want, 1e-5, f"ps={ps} vs ref")
    _close(got, pallas, 1e-5, f"ps={ps} vs pallas")


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"),        # the engine's mix: bf16 q, fp32 pool
])
def test_paged_matches_reference_across_dtypes(q_dtype, kv_dtype):
    case = _paged_case(1, B=3, KV=2, G=1, D=8, P=7, ps=8, PMAX=4,
                       q_dtype=q_dtype, kv_dtype=kv_dtype)
    got, pallas, want = _paged_all(case)
    assert got.dtype == getattr(torch, q_dtype)
    tol = TOL[q_dtype]
    _close(got, want, tol)
    _close(got, pallas, tol)


@pytest.mark.parametrize("window", [None, 10])
def test_paged_gqa_and_sliding_window(window):
    case = _paged_case(2, B=3, KV=2, G=4, D=16, P=8, ps=8, PMAX=4,
                       q_dtype="float32", kv_dtype="float32")
    got, pallas, want = _paged_all(case, sliding_window=window)
    _close(got, want, 1e-5)
    _close(got, pallas, 1e-5)


def test_paged_zero_length_rows_emit_exact_zeros():
    q, kp, vp, pt, _ = _paged_case(3, B=3, KV=2, G=2, D=8, P=6, ps=4,
                                   PMAX=3, q_dtype="float32",
                                   kv_dtype="float32")
    lengths = torch.as_tensor(np.asarray([0, 5, 0], np.int32))
    got = paged_decode_attention(q[1], kp[1], vp[1], pt[1], lengths)
    assert torch.all(got[0] == 0) and torch.all(got[2] == 0)
    assert torch.all(torch.isfinite(got))


def test_paged_layout_invariance_bitwise():
    """The same logical KV in two physical page layouts gives
    bitwise-identical output (the engine's token-fidelity contract)."""
    rng = np.random.RandomState(4)
    B, KV, G, D, ps, PMAX = 2, 2, 2, 16, 8, 4
    P = PMAX * B + 3
    S = PMAX * ps
    q = torch.as_tensor(rng.standard_normal((B, KV * G, D)), dtype=torch.float32)
    k_log = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v_log = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    lengths = torch.as_tensor(np.asarray([S - 3, ps + 1], np.int32))

    def layout(perm_seed):
        prng = np.random.RandomState(perm_seed)
        kp = prng.standard_normal((P, ps, KV, D)).astype(np.float32)
        vp = prng.standard_normal((P, ps, KV, D)).astype(np.float32)
        ids = prng.permutation(P)[:B * PMAX].reshape(B, PMAX)
        for b in range(B):
            for j in range(PMAX):
                kp[ids[b, j]] = k_log[b, j * ps:(j + 1) * ps]
                vp[ids[b, j]] = v_log[b, j * ps:(j + 1) * ps]
        return (torch.as_tensor(kp), torch.as_tensor(vp),
                torch.as_tensor(ids.astype(np.int32)))

    out1 = paged_decode_attention(q, *layout(10), lengths)
    out2 = paged_decode_attention(q, *layout(11), lengths)
    assert torch.equal(out1, out2)


def test_paged_ops_adapter_model_layout():
    q, kp, vp, pt, ln = _paged_case(6, B=3, KV=2, G=2, D=8, P=6, ps=4,
                                    PMAX=3, q_dtype="float32",
                                    kv_dtype="float32")
    got = ops.paged_attention(q[1][:, None], kp[1], vp[1], pt[1], ln[1])
    want = ref_ops.paged_attention(q[0][:, None], kp[0], vp[0], pt[0], ln[0])
    assert tuple(got.shape) == (3, 1, 4, 8)
    _close(got, want, 1e-5)


def test_paged_wrapper_validates_inputs():
    q, kp, vp, pt, ln = _paged_case(7, B=2, KV=2, G=1, D=8, P=4, ps=4,
                                    PMAX=2, q_dtype="float32",
                                    kv_dtype="float32")
    with pytest.raises(TypeError):
        paged_decode_attention(q[1], kp[1], vp[1], pt[1].long(), ln[1])
    with pytest.raises(ValueError):
        paged_decode_attention(q[1], kp[1], vp[1][:2], pt[1], ln[1])
    with pytest.raises(ValueError):
        paged_decode_attention(q[1], kp[1], vp[1], pt[1], ln[1],
                               sliding_window=0)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

def _flash_inputs(seed, B, Sq, Skv, H, HKV, D, q_dtype, kv_dtype):
    rng = np.random.RandomState(seed)
    q = _pair(rng.standard_normal((B, Sq, H, D)), q_dtype)
    k = _pair(rng.standard_normal((B, Skv, HKV, D)), kv_dtype)
    v = _pair(rng.standard_normal((B, Skv, HKV, D)), kv_dtype)
    return q, k, v


@pytest.mark.parametrize("Sq", [16, 64, 130])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_reference(Sq, group, dtype):
    q, k, v = _flash_inputs(Sq + group, 2, Sq, Sq, 4, 4 // group, 16,
                            dtype, dtype)
    got = flash_attention(q[1], k[1], v[1], causal=True)
    pallas = ref_ops.flash_attention(q[0], k[0], v[0], causal=True,
                                     block_q=32, block_k=32)
    want = jnp.moveaxis(jref.attention_ref(
        jnp.moveaxis(q[0], 1, 2), jnp.moveaxis(k[0], 1, 2),
        jnp.moveaxis(v[0], 1, 2), causal=True), 1, 2)
    tol = TOL[dtype]
    _close(got, want, tol, "vs ref")
    _close(got, pallas, tol, "vs pallas")


def test_flash_sliding_window():
    q, k, v = _flash_inputs(0, 1, 128, 128, 2, 2, 32, "float32", "float32")
    got = flash_attention(q[1], k[1], v[1], causal=True, sliding_window=32)
    pallas = ref_ops.flash_attention(q[0], k[0], v[0], causal=True,
                                     sliding_window=32, block_q=32,
                                     block_k=32)
    _close(got, pallas, 2e-5)


def test_flash_cache_masks_match_model_reference_path():
    """q at an offset into a longer fp32 cache, bf16 queries (the
    prefill's mix), kv_len masking the cache tail: against the
    reference model's ``gqa_attention``."""
    q, k, v = _flash_inputs(3, 2, 20, 48, 4, 2, 16, "bfloat16", "float32")
    got = flash_attention(q[1], k[1], v[1], causal=True, q_offset=8,
                          kv_len=28)
    want = jax_gqa(q[0], k[0], v[0], causal=True, q_offset=8, kv_len=28)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)


def test_flash_non_causal_ragged_kv():
    """Non-causal attention over a ragged kv_len needs no padding rule
    (the reference wrapper raises on that case)."""
    q, k, v = _flash_inputs(5, 1, 7, 33, 2, 1, 16, "float32", "float32")
    got = flash_attention(q[1], k[1], v[1], causal=False, kv_len=30)
    want = jax_gqa(q[0], k[0], v[0], causal=False, kv_len=30)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 7, 64, 300])
@pytest.mark.parametrize("d", [64, 512, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(rows, d, dtype):
    rng = np.random.RandomState(rows * 7 + d)
    x = _pair(rng.standard_normal((rows, d)), dtype)
    scale = _pair(1.0 + 0.1 * rng.standard_normal((d,)), "float32")
    got = rmsnorm(x[1], scale[1])
    want = jref.rmsnorm_ref(x[0], scale[0])
    pallas = pallas_rmsnorm(x[0], scale[0], block_rows=64, interpret=True)
    tol = TOL[dtype]
    assert got.dtype == x[1].dtype
    _close(got, want, tol, "vs ref")
    _close(got, pallas, tol, "vs pallas")


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version and launch nothing
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_path_and_count_no_launch():
    kernels.reset_launch_counts()
    x = torch.randn(5, 64)
    assert torch.equal(rmsnorm(x, torch.ones(64)),
                       ref.rmsnorm_ref(x, torch.ones(64)))
    q = torch.randn(1, 9, 2, 16)
    flash_attention(q, q, q)
    pt = torch.zeros((1, 2), dtype=torch.int32)
    paged_decode_attention(torch.randn(1, 2, 16), torch.randn(3, 4, 2, 16),
                           torch.randn(3, 4, 2, 16), pt,
                           torch.ones(1, dtype=torch.int32))
    ops.ssd_scan(torch.randn(1, 5, 2, 8), torch.rand(1, 5, 2),
                 -torch.rand(2), torch.randn(1, 5, 1, 4),
                 torch.randn(1, 5, 1, 4), torch.ones(2), chunk=4)
    assert kernels.launch_counts() == {"paged_attention": 0,
                                       "flash_attention": 0, "rmsnorm": 0,
                                       "ssd_scan": 0}


def test_plain_versions_context_matches_wrappers_on_cpu():
    x = torch.randn(3, 64)
    s = torch.rand(64)
    with ops.plain_versions():
        a = ops.rmsnorm(x, s)
    assert torch.equal(a, ops.rmsnorm(x, s))
