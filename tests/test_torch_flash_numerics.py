"""The tensor-core flash kernel's numerical contract, on the CPU.

``tests/_flash_emulation.py`` emulates the contract of
``src/repro_torch/csrc/flash_attention_tc.cu`` (K, V and P rounded to
bf16, fp32 sums and softmax statistics).  Here it is held against the
JAX package's attention (``repro.kernels.ref.attention_ref`` and the
model's ``repro.models.layers.gqa_attention``) and the port's own plain
path, on the same numpy inputs at the served head layouts: qwen1.5-0.5b
(H=16, D=64, prefill buckets 130 and 512) and zamba2-7b's shared block
(H=32, D=112, a 500-token prefill and one decode query over the 516-row
cache, ``kv_len`` masking its tail).  q is bf16; K/V hold bf16 values in
fp32, as the served caches do (they store bf16 projections).

Tolerance 2e-2 (atol and rtol), the port's bf16 tolerance: the output is
bf16 (one ulp is 2^-7 relative, 0.0156 at |o| in [2, 4)) and P is
rounded to bf16 (2^-9 relative per probability).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from _flash_emulation import flash_tc_emulation               # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro.models.layers import gqa_attention as jax_gqa      # noqa: E402
from repro_torch import kernels                               # noqa: E402
from repro_torch.bridge import to_tensor                      # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

TOL = 2e-2

# (B, Sq, Skv, H, D, q_offset, kv_len): the served calls' head layouts
CASES = {
    "qwen-prefill-130": (1, 130, 130, 16, 64, 0, None),
    "qwen-prefill-512": (1, 512, 512, 16, 64, 0, None),
    "zamba2-prefill-500": (1, 500, 516, 32, 112, 0, 500),
    "zamba2-decode": (2, 1, 516, 32, 112, 499, 500),
}


def _inputs(case, seed, bf16_exact_kv=True):
    """(jnp, torch) pairs of bf16 q and fp32 K/V, from one numpy seed."""
    B, Sq, Skv, H, D, _, _ = CASES[case]
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.standard_normal((B, Sq, H, D)), jnp.bfloat16)
    kv = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((B, Skv, H, D)), jnp.float32)
        if bf16_exact_kv:
            x = x.astype(jnp.bfloat16).astype(jnp.float32)
        kv.append(x)
    return [(j, to_tensor(np.asarray(j), device="cpu")) for j in (q, *kv)]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=what)


def _emulate(case, q, k, v):
    _, _, _, _, _, off, kv_len = CASES[case]
    return flash_tc_emulation(q, k, v, causal=True, q_offset=off,
                              kv_len=kv_len)


def _jax_attention_ref(case, q, k, v):
    """``repro.kernels.ref.attention_ref`` takes no offset or kv_len:
    give it the visible keys [0, kv_len), causal for a prefill from
    position 0, all visible for a decode query past them."""
    _, Sq, Skv, _, _, _, kv_len = CASES[case]
    n = Skv if kv_len is None else kv_len
    t = lambda x: jnp.transpose(x, (0, 2, 1, 3))          # noqa: E731
    out = jref.attention_ref(t(q), t(k[:, :n]), t(v[:, :n]),
                             causal=Sq > 1)
    return np.asarray(t(out).astype(jnp.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_tc_emulation_matches_jax_attention_ref(case):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(case, 0)
    _close(_emulate(case, tq, tk, tv).float(),
           _jax_attention_ref(case, jq, jk, jv), f"{case} vs attention_ref")


@pytest.mark.parametrize("case", list(CASES))
def test_tc_emulation_matches_jax_gqa_attention(case):
    _, _, _, _, _, off, kv_len = CASES[case]
    (jq, tq), (jk, tk), (jv, tv) = _inputs(case, 1)
    want = jax_gqa(jq, jk, jv, causal=True, q_offset=off, kv_len=kv_len)
    _close(_emulate(case, tq, tk, tv).float(),
           np.asarray(want.astype(jnp.float32)), f"{case} vs gqa_attention")


@pytest.mark.parametrize("case", list(CASES))
def test_tc_emulation_matches_port_plain_path(case):
    """The port's CPU path (the plain fp32 version the card holds the
    kernel against) agrees with the emulated contract."""
    _, _, _, _, _, off, kv_len = CASES[case]
    (_, tq), (_, tk), (_, tv) = _inputs(case, 2)
    got = flash_attention(tq, tk, tv, causal=True, q_offset=off,
                          kv_len=kv_len)
    _close(_emulate(case, tq, tk, tv).float(), got.float(),
           f"{case} vs the port's plain path")


@pytest.mark.parametrize("case", list(CASES))
def test_kv_rounding_error_on_values_not_bf16_exact(case, capsys):
    """K/V that are not bf16-exact (not what a served cache holds): the
    rounding adds error, printed here; the total stays within 2e-2.  q
    is upcast exactly to fp32 so that both outputs stay fp32 and the
    printed errors are not quantized by the output's bf16 rounding."""
    errs = {}
    for exact in (True, False):
        (jq, tq), (jk, tk), (jv, tv) = _inputs(case, 3, bf16_exact_kv=exact)
        got = _emulate(case, tq.float(), tk, tv).numpy()
        want = _jax_attention_ref(case, jq.astype(jnp.float32), jk, jv)
        errs[exact] = float(np.abs(got - want).max())
        _close(got, want, f"{case} bf16-exact K/V={exact}")
    with capsys.disabled():
        print(f"\n{case}: max |emulation - attention_ref| {errs[True]:.3e} "
              f"with bf16-exact K/V, {errs[False]:.3e} without "
              f"(K/V rounding adds {errs[False] - errs[True]:+.3e})")


def test_flash_variant_counters_sum_and_reset():
    """The flash wrapper counts each launch once in total and once by
    variant; a reset zeroes both."""
    fa = kernels.WRAPPERS["flash_attention"]
    fa.launches, fa.launches_tc, fa.launches_f32 = 5, 3, 2

    def flash_variants():
        return {k: v for k, v in kernels.variant_counts().items()
                if k.startswith("flash_attention.")}

    assert flash_variants() == {"flash_attention.tc": 3,
                                "flash_attention.f32": 2}
    assert kernels.launch_counts()["flash_attention"] == 5
    kernels.reset_launch_counts()
    assert flash_variants() == {"flash_attention.tc": 0,
                                "flash_attention.f32": 0}
    assert all(n == 0 for n in kernels.launch_counts().values())
