"""Port SSD scan vs the reference's, on the CPU.

The same numpy inputs go through the port's plain versions
(``ref.ssd_ref``, the sequential recurrence, and ``ref.ssd_chunked_ref``,
which the wrapper runs for CPU tensors) and through the reference's
``kernels.ref.ssd_ref``, its Pallas ``ssd_scan`` in interpret mode and
``models.mamba2.ssd_chunked``.  The shape grid and the 2e-4 tolerance are
``tests/test_kernels.py``'s SSD tests': the chunked forms sum in another
order than the token-by-token recurrence.  bf16 inputs are held within
2e-2.  The CUDA kernel itself is tested on the card in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import ops as ref_ops                      # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro.models import mamba2 as ref_mamba2                 # noqa: E402
from repro_torch import kernels                               # noqa: E402
from repro_torch.bridge import to_tensor                      # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan             # noqa: E402
from repro_torch.models import mamba2                         # noqa: E402

TOL = 2e-4
P, N = 8, 16


def _inputs(seed, B, S, H, G, dtype="float32"):
    """(jnp, torch) pairs holding the same bits, scaled as the reference
    suite's ``ssd_inputs``."""
    rng = np.random.RandomState(seed)
    softplus = lambda v: np.log1p(np.exp(v))                  # noqa: E731
    arrs = [rng.standard_normal((B, S, H, P)),
            softplus(rng.standard_normal((B, S, H))),
            -np.exp(0.5 * rng.standard_normal((H,))),
            rng.standard_normal((B, S, G, N)) / np.sqrt(N),
            rng.standard_normal((B, S, G, N)) / np.sqrt(N),
            np.ones((H,))]
    dtypes = [dtype, "float32", "float32", dtype, dtype, "float32"]
    out = []
    for a, dt in zip(arrs, dtypes):
        j = jnp.asarray(a, getattr(jnp, dt))
        out.append((j, to_tensor(np.asarray(j), device="cpu")))
    return out


def _close(got, want, tol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


# (B, S, H, G, chunk): every value of the reference suite's grid
# (B in {1,2}, S in {8,32,50,128}, H in {1,2,4}, G in {1,2}, chunk in
# {8,16,32}), with ragged tails (S=50) and chunk > S (Q = S)
GRID = [(1, 8, 1, 1, 8), (2, 32, 2, 2, 16), (1, 50, 4, 2, 16),
        (2, 128, 4, 1, 32), (2, 50, 2, 1, 32), (1, 128, 2, 2, 8),
        (2, 8, 4, 2, 32), (1, 32, 1, 1, 8), (2, 50, 4, 1, 8),
        (1, 128, 1, 1, 16)]


@pytest.mark.parametrize("B,S,H,G,chunk", GRID)
def test_ssd_plain_versions_match_reference(B, S, H, G, chunk):
    ins = _inputs(S + H, B, S, H, G)
    jx = [j for j, _ in ins]
    tx = [t for _, t in ins]
    want_y, want_h = jref.ssd_ref(*jx)
    seq_y, seq_h = ref.ssd_ref(*tx)
    _close(seq_y, want_y, TOL, "port ssd_ref y")
    _close(seq_h, want_h, TOL, "port ssd_ref state")
    got_y, got_h = ref.ssd_chunked_ref(*tx, chunk)
    for name, (wy, wh) in {
            "ref.ssd_ref": (want_y, want_h),
            "pallas interpret": ref_ops.ssd_scan(*jx, chunk=chunk),
            "mamba2.ssd_chunked": ref_mamba2.ssd_chunked(*jx, chunk)}.items():
        _close(got_y, wy, TOL, f"chunked y vs {name}")
        _close(got_h, wh, TOL, f"chunked state vs {name}")


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_initial_state_matches_reference(chunk):
    ins = _inputs(11, 1, 32, 2, 1)
    jx = [j for j, _ in ins]
    tx = [t for _, t in ins]
    h0 = np.random.RandomState(12).standard_normal((1, 2, P, N))
    jh0, th0 = jnp.asarray(h0, jnp.float32), torch.as_tensor(
        h0, dtype=torch.float32)
    want_y, want_h = jref.ssd_ref(*jx, init_state=jh0)
    pal_y, pal_h = ref_ops.ssd_scan(*jx, chunk=chunk, init_state=jh0)
    for fn in (lambda: ref.ssd_ref(*tx, init_state=th0),
               lambda: ref.ssd_chunked_ref(*tx, chunk, init_state=th0),
               lambda: ops.ssd_scan(*tx, chunk=chunk, init_state=th0)):
        y, h = fn()
        _close(y, want_y, TOL, "y vs ssd_ref")
        _close(h, want_h, TOL, "state vs ssd_ref")
        _close(y, pal_y, TOL, "y vs pallas")
        _close(h, pal_h, TOL, "state vs pallas")


def test_ssd_bf16_inputs_match_model_chunked_path():
    """bf16 x and B/C (the served dtype), fp32 dt: y comes back in bf16,
    the state in fp32, as the reference's model path gives them."""
    ins = _inputs(5, 2, 50, 4, 2, dtype="bfloat16")
    jx = [j for j, _ in ins]
    tx = [t for _, t in ins]
    want_y, want_h = ref_mamba2.ssd_chunked(*jx, 16)
    got_y, got_h = ssd_scan(*tx, chunk=16)
    assert got_y.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    _close(got_y, want_y, 2e-2, "bf16 y")
    _close(got_h, want_h, 2e-2, "bf16 state")


def test_cpu_tensors_launch_no_kernel():
    kernels.reset_launch_counts()
    tx = [t for _, t in _inputs(3, 1, 20, 2, 1)]
    y, h = ssd_scan(*tx, chunk=8)
    with ops.plain_versions():
        y2, h2 = ops.ssd_scan(*tx, chunk=8)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert kernels.launch_counts()["ssd_scan"] == 0


def test_ssd_wrapper_refuses_bad_shapes():
    x, dt, A, Bm, Cm, D = [t for _, t in _inputs(4, 1, 8, 4, 2)]
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :4], A, Bm, Cm, D)             # dt length
    with pytest.raises(ValueError):
        ssd_scan(x[:, :, :3], dt[:, :, :3], A[:3], Bm, Cm, D[:3])  # H % G
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm, D, init_state=torch.zeros(1, 4, P, 3))


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches_reference(G):
    rng = np.random.RandomState(7 + G)
    B, H = 3, 4
    arrs = [rng.standard_normal((B, H, P)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32),
            -np.exp(rng.standard_normal((H,))).astype(np.float32),
            rng.standard_normal((B, G, N)).astype(np.float32),
            rng.standard_normal((B, G, N)).astype(np.float32),
            np.ones((H,), np.float32),
            rng.standard_normal((B, H, P, N)).astype(np.float32)]
    want_y, want_s = ref_mamba2.ssd_decode_step(*map(jnp.asarray, arrs))
    got_y, got_s = mamba2.ssd_decode_step(*map(torch.as_tensor, arrs))
    _close(got_y, want_y, 1e-5, "decode y")
    _close(got_s, want_s, 1e-5, "decode state")


@pytest.mark.parametrize("x_dtype,prev_dtype", [("float32", None),
                                                ("bfloat16", "float32"),
                                                ("bfloat16", "bfloat16")])
def test_causal_conv1d_matches_reference(x_dtype, prev_dtype):
    """Streaming conv, dtype promotion included: an fp32 tail beside
    bf16 x gives bf16 y and an fp32 new tail."""
    rng = np.random.RandomState(8)
    B, S, C, w = 2, 5, 12, 4
    x = jnp.asarray(rng.standard_normal((B, S, C)), getattr(jnp, x_dtype))
    k = jnp.asarray(rng.standard_normal((w, C)), getattr(jnp, x_dtype))
    bias = jnp.asarray(rng.standard_normal((C,)), getattr(jnp, x_dtype))
    prev = None if prev_dtype is None else jnp.asarray(
        rng.standard_normal((B, w - 1, C)), getattr(jnp, prev_dtype))
    want_y, want_tail = ref_mamba2.causal_conv1d(x, k, bias, prev)
    tt = lambda a: None if a is None else to_tensor(np.asarray(a), "cpu")  # noqa: E731,E501
    got_y, got_tail = mamba2.causal_conv1d(tt(x), tt(k), tt(bias), tt(prev))
    assert str(got_y.dtype).split(".")[-1] == str(want_y.dtype)
    assert str(got_tail.dtype).split(".")[-1] == str(want_tail.dtype)
    tol = 1e-5 if x_dtype == "float32" else 2e-2
    _close(got_y, want_y, tol, "conv y")
    _close(got_tail, want_tail, 0.0, "conv tail")
