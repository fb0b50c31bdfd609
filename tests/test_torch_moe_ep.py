"""The moe expert layer under expert parallelism: ``moe.moe_mlp_fwd`` on
4-rank worlds over gloo (``tests/_dist_world.py``) against the
reference's ``moe_mlp_fwd`` on the whole batch (jitted, JAX on the CPU),
olmoe-1b-7b smoke (d 64, top-2) with the reference's weights through
numpy, a batch of 8 rows x 8 tokens:

* (data 1, model 4), ``expert`` over ``model``: 8 experts, 2 a rank;
* (data 1, model 4), ``expert_ff`` over ``model``: 6 experts, which 4
  does not divide, each rank 8 of each expert's 32 columns;
* (data 2, model 2): rows over ``data``, 4 experts a rank;
* (pod 2, data 1, model 2) under ``auto``: rows over ``pod``.

The dispatch group is the whole batch on every grid (the reference
builds its layers with one group, ``moe_groups=1``): capacity factor
1.25 drops entries (asserted) and 16 drops none.  Each rank's rows of
the output and its aux loss within 1e-5 in fp32 and 2e-2 in bf16; in
fp32 the gradients of ``sum(out * r) + 0.5 aux`` (x's rows, the router,
the rank's blocks of ``w_*``) against ``jax.grad`` of the reference's
layer within 1e-5, the router's equal in bits on every rank; each
token's experts and keep bits, gathered from the ranks in row order,
equal to the reference's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models import moe as ref_moe                       # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_ranks import MOE_AUX_WEIGHT, MOE_LAYOUTS           # noqa: E402
from _dist_world import load, run_world                       # noqa: E402
from test_torch_moe import _ref_routing                       # noqa: E402

ARCH = "olmoe-1b-7b"
B, S = 8, 8
CASES = [(cf, compute) for cf in (1.25, 16.0)
         for compute in ("float32", "bfloat16")]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
LEAVES = ("router", "w_down", "w_gate", "w_up")


def _cfg(E, cf, compute):
    import dataclasses
    return dataclasses.replace(SMOKE_ARCHS[ARCH], n_experts=E,
                               capacity_factor=cf, compute_dtype=compute)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's weights for 8 and 6 experts, the batch, the
    gradient's weights r; the 4-rank world's findings."""
    d = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(5)
    dm = SMOKE_ARCHS[ARCH].d_model
    arrays = {"x": rng.standard_normal((B, S, dm)).astype(np.float32),
              "r": rng.standard_normal((B, S, dm)).astype(np.float32)}
    for E in sorted({e for _, _, e in MOE_LAYOUTS.values()}):
        p = ref_moe.init_moe_mlp(jax.random.PRNGKey(1),
                                 _cfg(E, 1.25, "float32"), jnp.float32)
        arrays.update({f"E{E}_{k}": np.asarray(v) for k, v in p.items()})
    np.savez(d / "moe_layer.npz", **arrays)
    run_world(4, "moe_layer", d, cases=CASES)
    return arrays, [load(d, "moe_layer", r) for r in range(4)]


def _reference(arrays, E, cf, compute):
    """The reference layer on the whole batch: out, aux, routing and (in
    fp32) the gradients of ``sum(out * r) + MOE_AUX_WEIGHT * aux``."""
    cfg = _cfg(E, cf, compute)
    p = {k: jnp.asarray(arrays[f"E{E}_{k}"]).astype(JDT[compute])
         for k in LEAVES}
    p["router"] = p["router"].astype(jnp.float32)
    x = jnp.asarray(arrays["x"]).astype(JDT[compute])

    def f(p, x):
        return ref_moe.moe_mlp_fwd(p, x, cfg)

    out, aux = jax.jit(f)(p, x)
    grads = None
    if compute == "float32":
        def loss(p, x):
            y, a = f(p, x)
            return (y * arrays["r"]).sum() + MOE_AUX_WEIGHT * a
        grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    idx, keep, _ = _ref_routing(p, x, cfg, 1)
    flat = idx[0].reshape(-1)
    order = np.argsort(flat, kind="stable")
    kept = np.empty_like(keep[0])
    kept[order] = keep[0]
    return (np.asarray(out, np.float32), float(aux), grads, idx[0],
            kept.reshape(B * S, -1))


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("layout", list(MOE_LAYOUTS))
def test_expert_layer_matches_reference_whole_batch(world, layout, case):
    arrays, ranks = world
    cf, compute = case
    E = MOE_LAYOUTS[layout][2]
    out, aux, grads, idx, kept = _reference(arrays, E, cf, compute)
    tol = TOL[compute]
    got_idx, got_kept, seen = [], [], set()
    for r, rank in enumerate(ranks):
        res = rank[(layout, cf, compute)]
        start, rows = res["rows"]
        _close(res["out"].reshape(rows, S, -1), out[start:start + rows],
               tol, f"out rank {r}")
        assert abs(res["aux"] - aux) <= tol * abs(aux), (res["aux"], aux)
        if start not in seen:
            seen.add(start)
            got_idx.append(res["expert_idx"])
            got_kept.append(res["kept"])
        else:                      # a model group's ranks route alike
            assert np.array_equal(res["kept"], got_kept[-1])
        if grads is None:
            continue
        gp, gx = grads
        _close(res["grad_x"], gx[start:start + rows], 1e-5, f"dx {r}")
        for k in LEAVES:
            want = np.asarray(gp[k])[res["blocks"][k]]
            _close(res[f"grad_{k}"], want, 1e-5, f"d{k} rank {r}")
        assert res["grad_router"].equal(ranks[0][(layout, cf, compute)]
                                        ["grad_router"])
    assert np.array_equal(torch.cat(got_idx).numpy(), idx)
    assert np.array_equal(torch.cat(got_kept).numpy(), kept)
    drops = int((~kept).sum())
    assert (drops > 0) == (cf == 1.25), drops
    # record_routing's keep bits, in the rank's dispatch order: a drop
    # shows where the batch's earlier rows filled the capacity
    assert any(bool((~rank[(layout, cf, compute)]["keep"]).any())
               for rank in ranks) == (cf == 1.25)


def test_expert_layer_collectives(world):
    """The whole-batch group's collectives: one gather of the entries'
    experts over the batch axes a call (where rows are split), one
    all-reduce of the probabilities' sum for the aux loss; over
    ``model`` the partial outputs' sum once a call, and in a backward
    the dispatched input's and the gates' gradients once each."""
    _, ranks = world
    for layout, (shape, axes, _) in MOE_LAYOUTS.items():
        rows = "+".join(a for a, n in zip(axes, shape)
                        if a != "model" and n > 1)
        for cf, compute in CASES:
            calls = ranks[0][(layout, cf, compute)]["collectives"]
            grad = compute == "float32"
            want = {"model:all-reduce:moe": 1 + grad}
            if grad:
                want["model:all-reduce:moe-gates"] = 1
            if rows:
                want[f"{rows}:all-gather:moe-experts"] = 1
                want[f"{rows}:all-reduce:moe-aux"] = 1
                if grad:               # the test's mean of the gradients
                    want[f"{rows}:all-reduce"] = len(LEAVES)
            assert calls == want, (layout, cf, compute, calls)
