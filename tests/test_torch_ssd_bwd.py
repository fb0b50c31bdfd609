"""The SSD scan's gradient on the CPU: autograd of the port's plain
version (``ref.ssd_chunked_ref``, what ``ssd_scan`` runs on a CPU
tensor), the step-by-step emulation of the fp32 backward kernel
(``tests/_ssd_bwd_emulation.py``, whose order of sums
``csrc/ssd_scan_bwd.cu`` follows) and the emulation of the bf16
tensor-core kernel's contract (``tests/_ssd_bwd_tc_emulation.py``:
``csrc/ssd_scan_bwd_tc.cu``'s chunking, hi + lo splits, <g', h'>
identity and head-run sums) against ``jax.vjp`` of the reference's
``ssd_chunked`` (``repro.models.mamba2``).

Inputs are drawn with numpy from a seed: x, B and C in the case's dtype
(bf16 values enter both packages alike), dt > 0, A < 0 and D fp32, and
where the case has one an initial state and a gradient of the final
state.  Shapes cover a ragged tail (S=150 at chunk 64; the smoke
configs' S=20 at chunk 8) and G in {1, 2}.  Tolerances, of each
gradient's largest |value|: 1e-5 in fp32 (the reference's associative
scan sums the states in another order), but 4e-5 for dA, a sum over
every position of dt_j da_j whose terms cancel: against a float64
evaluation of the same formula the reference's own fp32 dA lies up to
1.1e-5 of |dA| away on these inputs (the plain version's 8.2e-6, the
emulation's 6.6e-6), so two fp32 evaluations may differ by twice that;
2e-2 when x, B and C are bf16 (dx, dB and dC are rounded to bf16 on
both sides, from sums taken in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _ssd_bwd_emulation import ssd_bwd_emulation              # noqa: E402
from _ssd_bwd_tc_emulation import ssd_bwd_tc_emulation        # noqa: E402
from repro.models.mamba2 import ssd_chunked                   # noqa: E402
from repro_torch import kernels                               # noqa: E402
from repro_torch.kernels import ssd_scan as ssd               # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DA_TOL_F32 = 4e-5
SSD_FP32_TOL = 2e-4   # the card's fp32 SSD tolerance (chip_smoke SSD_TOL)
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
# (B, S, H, P, N, chunk)
SHAPES = {"ragged": (2, 150, 4, 16, 16, 64), "smoke": (2, 20, 4, 16, 16, 8),
          "heads6": (2, 150, 6, 16, 16, 64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: intra-op threads only contend with the other
    test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, G, dtype, init, seed=0):
    """numpy fp32 arrays (x, B, C, dy rounded to ``dtype``'s values)."""
    Bsz, S, H, P, N, _ = SHAPES[shape]
    rng = np.random.default_rng(seed)

    def rounded(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            getattr(torch, dtype)).float().numpy()

    out = {"x": rounded(rng.standard_normal((Bsz, S, H, P))),
           "dt": np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))
                          ).astype(np.float32),
           "A": (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32),
           "B": rounded(rng.standard_normal((Bsz, S, G, N)) / N ** 0.5),
           "C": rounded(rng.standard_normal((Bsz, S, G, N)) / N ** 0.5),
           "D": (1 + 0.1 * rng.standard_normal(H)).astype(np.float32),
           "dy": rounded(rng.standard_normal((Bsz, S, H, P)))}
    if init:
        out["h0"] = rng.standard_normal((Bsz, H, P, N)).astype(np.float32)
        out["dstate"] = rng.standard_normal((Bsz, H, P, N)).astype(
            np.float32)
    return out


def _reference(arrs, chunk, dtype):
    """``jax.vjp`` of ``ssd_chunked`` at (dy, dstate): the seven
    gradients as fp32 numpy (dh0 None without an initial state)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    prim = [jnp.asarray(arrs["x"]).astype(jdt), jnp.asarray(arrs["dt"]),
            jnp.asarray(arrs["A"]), jnp.asarray(arrs["B"]).astype(jdt),
            jnp.asarray(arrs["C"]).astype(jdt), jnp.asarray(arrs["D"])]
    init = "h0" in arrs
    if init:
        prim.append(jnp.asarray(arrs["h0"]))

    def f(*a):
        return ssd_chunked(*a[:6], chunk, init_state=a[6] if init else None)

    (y, state), vjp = jax.vjp(f, *prim)
    dstate = (jnp.asarray(arrs["dstate"]) if init
              else jnp.zeros_like(state))
    grads = vjp((jnp.asarray(arrs["dy"]).astype(y.dtype), dstate))
    out = [np.asarray(g, np.float32) for g in grads]
    return out + ([] if init else [None])


def _port_tensors(arrs, dtype):
    dt_ = getattr(torch, dtype)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    for k in ("x", "B", "C", "dy"):
        t[k] = t[k].to(dt_)
    return t


def _hold(got, want, dtype, what):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, (what, name)
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(g.float().numpy() - w).max())
        tol = DA_TOL_F32 if (name, dtype) == ("dA", "float32") \
            else TOL[dtype]
        assert scale > 0 and err <= tol * scale, (what, name, err, scale)


CASES = [(shape, G, dtype, init) for shape in ("ragged", "smoke")
         for G in (1, 2) for dtype in ("float32", "bfloat16")
         for init in (False, True)]


@pytest.mark.parametrize("shape,G,dtype,init", CASES)
def test_plain_and_emulated_gradients_match_jax_vjp(shape, G, dtype, init):
    """Autograd through ``ssd_scan`` on CPU tensors (the plain version)
    and the backward kernel's emulation, each against the reference's
    ``jax.vjp``."""
    arrs = _inputs(shape, G, dtype, init)
    chunk = SHAPES[shape][-1]
    want = _reference(arrs, chunk, dtype)
    t = _port_tensors(arrs, dtype)
    leaves = [t[k].clone().requires_grad_(True)
              for k in ("x", "dt", "A", "B", "C", "D")]
    h0 = t["h0"].clone().requires_grad_(True) if init else None
    y, state = ssd.ssd_scan(*leaves, chunk=chunk, init_state=h0)
    assert y.dtype == t["x"].dtype and state.dtype == torch.float32
    loss = (y.float() * t["dy"].float()).sum()
    if init:
        loss = loss + (state * t["dstate"]).sum()
    loss.backward()
    plain = [g.grad for g in leaves] + [None if h0 is None else h0.grad]
    assert [g.dtype for g in plain[:6]] == [g.dtype for g in leaves]
    _hold(plain, want, dtype, "plain")
    emu = ssd_bwd_emulation(t["x"], t["dt"], t["A"], t["B"], t["C"],
                            t["D"], t["dy"], chunk=chunk,
                            init_state=t.get("h0"),
                            dstate=t.get("dstate"))
    _hold(emu, want, dtype, "emulation")


def test_emulation_chunking_does_not_change_the_function():
    """The backward walks chunks of its own (min(Q, 64)): the same
    gradients, to fp32 rounding, as the forward's chunk of 128 gives
    through autograd of the plain version, on a 300-token sequence."""
    arrs = _inputs("ragged", 2, "float32", True, seed=3)
    rng = np.random.default_rng(4)
    for k, shape in (("x", (2, 300, 4, 16)), ("dt", (2, 300, 4)),
                     ("B", (2, 300, 2, 16)), ("C", (2, 300, 2, 16)),
                     ("dy", (2, 300, 4, 16))):
        arrs[k] = rng.standard_normal(shape).astype(np.float32)
    arrs["dt"] = np.log1p(np.exp(arrs["dt"])).astype(np.float32)
    t = _port_tensors(arrs, "float32")
    leaves = [t[k].clone().requires_grad_(True)
              for k in ("x", "dt", "A", "B", "C", "D", "h0")]
    y, state = ssd.ssd_scan(*leaves[:6], chunk=128, init_state=leaves[6])
    ((y * t["dy"]).sum() + (state * t["dstate"]).sum()).backward()
    emu = ssd_bwd_emulation(t["x"], t["dt"], t["A"], t["B"], t["C"],
                            t["D"], t["dy"], chunk=128,
                            init_state=t["h0"], dstate=t["dstate"])
    _hold(emu, [g.grad.numpy() for g in leaves], "float32", "chunk 64")


def test_check_backward_names_the_limits():
    """The limits a training entry point checks before its first step."""
    ssd.check_backward(64, 128, 128, torch.bfloat16)
    ssd.check_backward(32, 12, 64, torch.float32)
    with pytest.raises(ValueError, match=r"P in \(32, 64\)"):
        ssd.check_backward(16, 16, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="N <= 128"):
        ssd.check_backward(64, 256, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="chunk <= 128"):
        ssd.check_backward(64, 128, 256, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ssd.check_backward(64, 12, 128, torch.bfloat16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ssd.check_backward(64, 128, 128, torch.float16)


# (shape, G, init, run): bf16 inputs; runs of 4 heads, and the 6-head
# shape whose run of 4 leaves a run of 2 (G=1) or covers a 3-head group
# (G=2)
TC_CASES = [(shape, G, init, 4) for shape in ("ragged", "smoke")
            for G in (1, 2) for init in (False, True)] + [
    ("heads6", 1, True, 4), ("heads6", 2, False, 4), ("ragged", 1, True, 3)]


def _tc_emulation(arrs, chunk, run, terms=2):
    t = _port_tensors(arrs, "bfloat16")
    return ssd_bwd_tc_emulation(t["x"], t["dt"], t["A"], t["B"], t["C"],
                                t["D"], t["dy"], chunk=chunk,
                                init_state=t.get("h0"),
                                dstate=t.get("dstate"), run=run,
                                terms=terms)


@pytest.mark.parametrize("shape,G,init,run", TC_CASES)
def test_tc_emulation_matches_jax_vjp(shape, G, init, run):
    """The bf16 tensor-core backward's contract against the reference's
    ``jax.vjp``, within 2e-2 of each gradient's largest |value|; dx, dB
    and dC come out bf16, the rest fp32."""
    arrs = _inputs(shape, G, "bfloat16", init)
    chunk = SHAPES[shape][-1]
    want = _reference(arrs, chunk, "bfloat16")
    emu = _tc_emulation(arrs, chunk, run)
    assert [None if g is None else g.dtype for g in emu] == [
        torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
        torch.bfloat16, torch.float32, torch.float32 if init else None]
    _hold(emu, want, "bfloat16", f"tc emulation run={run}")


def test_tc_emulation_one_term_would_miss_the_fp32_tolerance(capsys):
    """What the hi + lo split buys: with hi alone the fp32 gradients (ddt,
    dA, dh0) land past the SSD kernels' fp32 tolerance (2e-4 of the
    largest |grad|) from ``jax.vjp``, with both halves far inside it; the
    measured errors are printed."""
    arrs = _inputs("ragged", 1, "bfloat16", True)
    want = _reference(arrs, 64, "bfloat16")
    errs = {}
    for terms in (1, 2):
        emu = _tc_emulation(arrs, 64, 4, terms=terms)
        errs[terms] = max(
            float(np.abs(g.float().numpy() - w).max() / np.abs(w).max())
            for name, g, w in zip(NAMES, emu, want)
            if name in ("ddt", "dA", "dh0"))
    with capsys.disabled():
        print(f"\nssd backward, fp32 gradients: largest error {errs[2]:.3e} "
              f"of the largest |grad| with hi + lo, {errs[1]:.3e} with hi "
              f"alone (tolerance {SSD_FP32_TOL})")
    assert errs[1] > SSD_FP32_TOL > errs[2]


def test_bwd_run_fills_the_card():
    """Runs of 8 heads at mamba2's and zamba2's training calls (384 and
    896 blocks); halved, down to one head, while the grid would give
    the 132 SMs fewer than two blocks each."""
    assert ssd.bwd_run(8, 512, 48, 1, 128) == 8
    assert ssd.bwd_run(8, 512, 112, 1, 128) == 8
    assert ssd.bwd_run(4, 512, 48, 1, 128) == 4
    assert ssd.bwd_run(2, 300, 8, 2, 128) == 1
    assert ssd.bwd_run(1, 512, 48, 1, 128) == 1


def test_ssd_backward_variant_counters_sum_and_reset():
    """The SSD wrapper counts each backward call once in total and once
    by variant (``ssd_scan_bwd.tc`` bf16, ``.f32`` fp32); a reset zeroes
    both, and a CPU tensor's gradient (autograd of the plain version)
    counts nothing."""
    mod = kernels.BACKWARD["ssd_scan_bwd"]
    mod.launches_bwd, mod.launches_bwd_tc, mod.launches_bwd_f32 = 7, 4, 3
    counts = kernels.backward_variant_counts()
    assert counts["ssd_scan_bwd.tc"] == 4 and counts["ssd_scan_bwd.f32"] == 3
    assert kernels.backward_counts()["ssd_scan_bwd"] == 7
    kernels.reset_launch_counts()
    assert all(n == 0 for n in kernels.backward_variant_counts().values())
    t = _port_tensors(_inputs("smoke", 1, "bfloat16", False), "bfloat16")
    x = t["x"].clone().requires_grad_(True)
    y, _ = ssd.ssd_scan(x, t["dt"], t["A"], t["B"], t["C"], t["D"], chunk=8)
    y.float().sum().backward()
    assert x.grad is not None
    assert not any(kernels.backward_counts().values())
    assert not any(kernels.backward_variant_counts().values())
