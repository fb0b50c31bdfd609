"""The tensor-core SSD kernel's numerical contract, on the CPU.

``tests/_ssd_emulation.py`` emulates the contract of
``src/repro_torch/csrc/ssd_scan_tc.cu`` in its order of products: x, B
and C exact in bf16, each fp32 operand (the weighted scores, the state
h, s_k x) split into bf16 hi + lo with both halves multiplied and summed
in fp32.  Here it is held against the JAX package's Pallas
``repro.kernels.ssd_scan.ssd_scan`` (interpret mode) and the port's
plain ``repro_torch.kernels.ref.ssd_chunked_ref``, on the same numpy
inputs (bf16-exact x, B and C, fp32 dt, the smoke's scales) at the
smoke's tolerances: y 2e-2 in bf16, the fp32 state 2e-4.  The shapes
keep the served head widths (P = 64 with N = 128 as mamba2-780m, N = 64
as zamba2-7b; P = 32 with G = 2) at a few heads, with ragged tails, a
prompt shorter than one chunk and an initial state.

Why two terms: with ``hi`` alone (plain bf16 operands) the state misses
2e-4 -- its error is 1.0e-3 in the "mamba2-heads-init" case and 2.0e-3
in "p32-g2-chunk64" (3.4e-3 at B=2, S=500, H=4, N=128, P=64) -- while
the hi + lo split stays within 5e-6 (7e-6);
``test_one_term_would_miss_the_state_tolerance`` measures and prints
both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from _ssd_emulation import ssd_tc_emulation                   # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd     # noqa: E402
from repro_torch import kernels                               # noqa: E402
from repro_torch.kernels import ref                           # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan             # noqa: E402

Y_TOL, STATE_TOL = 2e-2, 2e-4

# (B, S, H, G, N, P, chunk, init_state)
CASES = {
    "mamba2-heads-ragged": (1, 300, 2, 1, 128, 64, 128, False),
    "mamba2-heads-init": (1, 300, 2, 1, 128, 64, 128, True),
    "zamba2-heads-init": (2, 200, 2, 1, 64, 64, 128, True),
    "short-prompt": (1, 100, 2, 1, 128, 64, 128, True),
    "p32-g2-chunk64": (1, 150, 4, 2, 64, 32, 64, True),
}


def _inputs(case, seed=0):
    """(jnp, torch) pairs holding the same bits: bf16 x, B and C, fp32
    dt, A, D and initial state."""
    B, S, H, G, N, P, _, init = CASES[case]
    rng = np.random.RandomState(seed)
    softplus = lambda v: np.log1p(np.exp(v))                  # noqa: E731
    arrs = [(rng.standard_normal((B, S, H, P)), "bfloat16"),
            (softplus(rng.standard_normal((B, S, H))), "float32"),
            (-np.exp(0.5 * rng.standard_normal((H,))), "float32"),
            (rng.standard_normal((B, S, G, N)) / np.sqrt(N), "bfloat16"),
            (rng.standard_normal((B, S, G, N)) / np.sqrt(N), "bfloat16"),
            (np.ones((H,)), "float32")]
    if init:
        arrs.append((rng.standard_normal((B, H, P, N)), "float32"))
    out = []
    for a, dt in arrs:
        j = jnp.asarray(a, getattr(jnp, dt))
        t = torch.as_tensor(np.array(j.astype(jnp.float32))).to(
            getattr(torch, dt))
        out.append((j, t))
    return out


def _split(case):
    pairs = _inputs(case)
    j = [a for a, _ in pairs]
    t = [b for _, b in pairs]
    j0 = j[6] if len(j) > 6 else None
    t0 = t[6] if len(t) > 6 else None
    return j[:6], j0, t[:6], t0


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_tc_emulation_matches_pallas_kernel(case):
    chunk = CASES[case][6]
    jargs, jh0, targs, th0 = _split(case)
    wy, wh = pallas_ssd(*jargs, chunk=chunk, init_state=jh0)
    y, h = ssd_tc_emulation(*targs, chunk, init_state=th0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(y.float(), wy.astype(jnp.float32), Y_TOL, f"{case} y")
    _close(h, wh, STATE_TOL, f"{case} state")


@pytest.mark.parametrize("case", list(CASES))
def test_tc_emulation_matches_port_plain_version(case):
    chunk = CASES[case][6]
    _, _, targs, th0 = _split(case)
    wy, wh = ref.ssd_chunked_ref(*targs, chunk, init_state=th0)
    y, h = ssd_tc_emulation(*targs, chunk, init_state=th0)
    _close(y.float(), wy.float(), Y_TOL, f"{case} y")
    _close(h, wh, STATE_TOL, f"{case} state")


@pytest.mark.parametrize("case", ["mamba2-heads-init", "p32-g2-chunk64"])
def test_one_term_would_miss_the_state_tolerance(case, capsys):
    """The measured state error of the hi + lo split and of hi alone
    against the plain fp32 version, printed; the split holds 2e-4, one
    bf16 term does not."""
    chunk = CASES[case][6]
    _, _, targs, th0 = _split(case)
    _, wh = ref.ssd_chunked_ref(*targs, chunk, init_state=th0)
    errs = {}
    for terms in (1, 2):
        _, h = ssd_tc_emulation(*targs, chunk, init_state=th0, terms=terms)
        errs[terms] = float((h - wh).abs().max())
    with capsys.disabled():
        print(f"\n{case}: max |state - plain| {errs[2]:.3e} with hi + lo, "
              f"{errs[1]:.3e} with hi alone (tolerance {STATE_TOL})")
    _close(ssd_tc_emulation(*targs, chunk, init_state=th0)[1], wh,
           STATE_TOL, f"{case} state, two terms")
    assert errs[1] > STATE_TOL > errs[2]


def test_ssd_variant_counters_sum_and_reset():
    """The SSD wrapper counts each launch once in total and once by
    variant; a reset zeroes both, and a CPU tensor takes the plain
    version without counting a launch."""
    mod = kernels.WRAPPERS["ssd_scan"]
    mod.launches, mod.launches_tc, mod.launches_f32 = 7, 4, 3
    counts = kernels.variant_counts()
    assert counts["ssd_scan.tc"] == 4 and counts["ssd_scan.f32"] == 3
    assert kernels.launch_counts()["ssd_scan"] == 7
    kernels.reset_launch_counts()
    assert all(n == 0 for n in kernels.variant_counts().values())
    _, _, targs, th0 = _split("short-prompt")
    y, h = ssd_scan(*targs, chunk=128, init_state=th0)
    wy, wh = ref.ssd_chunked_ref(*targs, 128, init_state=th0)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert kernels.launch_counts()["ssd_scan"] == 0
    assert all(n == 0 for n in kernels.variant_counts().values())

