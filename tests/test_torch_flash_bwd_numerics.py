"""The tensor-core flash backward's numerical contract, on the CPU.

``tests/_flash_bwd_emulation.py`` emulates the contract of
``src/repro_torch/csrc/flash_attention_bwd_tc.cu`` (P and dS rounded to
bf16 before the three gradient products, fp32 sums, the forward's fp32
log-sum-exp, delta = rowsum(dO * O) over the bf16 output).  Here it is
held against JAX's gradient (``jax.vjp``) of the reference's attention,
``repro.kernels.ref.attention_ref`` and the model's
``repro.models.layers.gqa_attention`` (the function XLA differentiates in
training), and against autograd of the port's own plain path, on the
same numpy inputs: olmo-1b's head layout (D=128, S 130 and 256), qwen's
(D=64), GQA with a sliding window, non-causal attention over a ragged
kv_len, a q_offset with kv_len, and rows with no visible key.  q, k, v
and dout hold bf16 values; the references differentiate them in fp32.

Tolerance: each gradient within 2e-2 of its largest |value|, the bf16
tolerance phase 3 of ``chip_smoke.py`` holds the kernel to: P and dS are
rounded to bf16 (2^-9 relative each), so are the forward's output (which
enters delta) and every gradient (up to 2^-8 of the largest).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _flash_bwd_emulation import flash_bwd_tc_emulation       # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro.models.layers import gqa_attention as jax_gqa      # noqa: E402
from repro_torch import kernels                               # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

TOL = 2e-2

# (B, Sq, Skv, H, HKV, D, causal, window, q_offset, kv_len)
CASES = {
    "olmo-130": (1, 130, 130, 4, 4, 128, True, None, 0, None),
    "olmo-256": (1, 256, 256, 4, 4, 128, True, None, 0, None),
    "qwen-130": (2, 130, 130, 4, 4, 64, True, None, 0, None),
    "gqa-window": (1, 200, 200, 8, 2, 64, True, 48, 0, None),
    "non-causal-ragged-kv": (2, 40, 100, 4, 4, 64, False, None, 0, 90),
    "q_offset-kv_len": (1, 50, 96, 4, 2, 128, True, None, 20, 70),
    "rows-without-keys": (2, 70, 96, 8, 2, 64, True, 8, 0, 13),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The cases are small: intra-op threads only contend with the other
    test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mask(case):
    """(Sq, Skv) visibility of the case's masks."""
    _, Sq, Skv, _, _, _, causal, window, off, kv_len = CASES[case]
    qp = np.arange(Sq)[:, None] + off
    kp = np.arange(Skv)[None, :]
    m = (kp < (Skv if kv_len is None else kv_len)) & (qp >= 0)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    return m


def _inputs(case, seed):
    """fp32 numpy q, k, v, dout holding bf16 values; dout is zero on the
    rows with no visible key (where the reference's -1e30 mask gives a
    uniform softmax instead of the kernels' zeros)."""
    B, Sq, Skv, H, HKV, D = CASES[case][:6]
    rng = np.random.RandomState(seed)

    def bf16(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    q, do = bf16((B, Sq, H, D)), bf16((B, Sq, H, D))
    k, v = bf16((B, Skv, HKV, D)), bf16((B, Skv, HKV, D))
    do[:, ~_mask(case).any(1)] = 0.0
    return q, k, v, do


def _kw(case):
    _, _, _, _, _, _, causal, window, off, kv_len = CASES[case]
    return dict(causal=causal, sliding_window=window, q_offset=off,
                kv_len=kv_len)


def _emulate(case, q, k, v, do):
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    return [g.float().numpy() for g in flash_bwd_tc_emulation(*t,
                                                              **_kw(case))]


def _hold(got, want, case, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        err = float(np.abs(np.asarray(g, np.float32) - w).max())
        assert scale > 0 and err <= TOL * scale, (case, what, name, err,
                                                  scale)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_emulation_matches_jax_gqa_attention_vjp(case):
    q, k, v, do = _inputs(case, 0)
    kw = _kw(case)
    _, vjp = jax.vjp(lambda a, b, c: jax_gqa(
        a, b, c, causal=kw["causal"], q_offset=kw["q_offset"],
        sliding_window=kw["sliding_window"], kv_len=kw["kv_len"]),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _hold(_emulate(case, q, k, v, do), vjp(jnp.asarray(do)), case,
          "gqa_attention")


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][8] == 0])
def test_bwd_emulation_matches_jax_attention_ref_vjp(case):
    """``repro.kernels.ref.attention_ref`` (layout (B,H,S,D)) takes no
    offset or kv_len: it gets the keys [0, kv_len), and the gradient of
    the keys past them is zero."""
    _, _, Skv, _, _, _, causal, window, _, kv_len = CASES[case]
    n = Skv if kv_len is None else kv_len
    q, k, v, do = _inputs(case, 1)
    t = lambda x: jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))  # noqa: E731
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=causal, sliding_window=window),
        t(q), t(k[:, :n]), t(v[:, :n]))
    dq, dk, dv = (np.asarray(jnp.transpose(g, (0, 2, 1, 3)))
                  for g in vjp(t(do)))
    pad = lambda g: np.concatenate(  # noqa: E731
        [g, np.zeros((g.shape[0], Skv - n) + g.shape[2:], g.dtype)], 1)
    _hold(_emulate(case, q, k, v, do), (dq, pad(dk), pad(dv)), case,
          "attention_ref")


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_emulation_matches_port_plain_autograd(case):
    """Autograd of the port's CPU path (the plain version the card holds
    the kernel against) agrees with the emulated contract."""
    q, k, v, do = _inputs(case, 2)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    kernels.reset_launch_counts()
    flash_attention(*leaves, **_kw(case)).backward(torch.from_numpy(do))
    assert kernels.backward_counts()["flash_attention_bwd"] == 0
    _hold(_emulate(case, q, k, v, do), [t.grad.numpy() for t in leaves],
          case, "the port's plain path")


def test_bwd_emulation_zeros_rows_without_keys_and_unseen_keys():
    """With dout non-zero everywhere, the rows that see no key get exact
    zero dq, and the keys at or past kv_len exact zero dk and dv."""
    case = "rows-without-keys"
    q, k, v, _ = _inputs(case, 3)
    do = np.random.RandomState(4).standard_normal(q.shape).astype(
        np.float32)
    dq, dk, dv = _emulate(case, q, k, v, do)
    dead = ~_mask(case).any(1)
    assert dead.sum() == 50 and not dq[:, dead].any()
    assert np.abs(dq[:, ~dead]).max() > 0
    assert not dk[:, 13:].any() and not dv[:, 13:].any()
    assert np.abs(dk[:, :13]).max() > 0 and np.abs(dv[:, :13]).max() > 0


def test_flash_backward_variant_counters_sum_and_reset():
    """The flash wrapper counts each backward call once in total and once
    by variant; a reset zeroes both."""
    fa = kernels.BACKWARD["flash_attention_bwd"]
    fa.launches_bwd, fa.launches_bwd_tc, fa.launches_bwd_f32 = 5, 3, 2

    def flash_variants():
        return {k: v for k, v in kernels.backward_variant_counts().items()
                if k.startswith("flash_attention_bwd.")}

    assert flash_variants() == {
        "flash_attention_bwd.tc": 3, "flash_attention_bwd.f32": 2}
    assert kernels.backward_counts()["flash_attention_bwd"] == 5
    kernels.reset_launch_counts()
    assert flash_variants() == {
        "flash_attention_bwd.tc": 0, "flash_attention_bwd.f32": 0}
    assert all(n == 0 for n in kernels.backward_variant_counts().values())
    assert all(n == 0 for n in kernels.backward_counts().values())
