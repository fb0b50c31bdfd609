"""Port vs reference: the hierarchical collectives on the CPU.

``repro_torch.core.hierarchy`` on a 4-rank ``(pod 2, data 2, model 1)``
gloo world (``tests/_dist_world.py``) against ``repro.core.hierarchy``:
the int8 quantizer in bits; flat and hierarchical all-reduce equal to
each other and to the literal sum (as ``tests/test_hierarchy.py``
checks the reference); the compressed cross-pod mean against the
reference's under ``jax.vmap(..., axis_name="pod")`` over the stacked
per-pod inputs (codes equal, values within 1e-6); the error-feedback
mean over 20 steps; and the byte counter, the port's counterpart of the
reference's HLO-parsed ``cross_pod_moved_bytes``: under
``hierarchical`` the pod groups move under half of the flat
all-reduce's bytes, and about a quarter of that again with
``compress_pod``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import hierarchy as ref_h                     # noqa: E402
from repro_torch.core import hierarchy as h                   # noqa: E402
from repro_torch.launch import mesh as mesh_lib               # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import load, run_world                       # noqa: E402


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's findings from ``_dist_ranks.hierarchy``."""
    out = tmp_path_factory.mktemp("hierarchy")
    run_world(4, "hierarchy", out, seed=0)
    return [load(out, "hierarchy", r) for r in range(4)]


def _inputs(seed=0):
    """``_dist_ranks.hierarchy``'s per-pod vectors and residuals."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((2, 3, 64)).astype(np.float32)
    rs = (0.01 * rng.standard_normal((2, 3, 64))).astype(np.float32)
    return xs, rs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_matches_reference_in_bits(seed):
    x = np.random.default_rng(seed).standard_normal((5, 33)).astype(
        np.float32) * (10.0 ** seed)
    q, s = h.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_h.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.asarray(s, np.float32).tobytes() == np.asarray(
        rs, np.float32).tobytes()
    got = h.dequantize_int8(q, s).numpy()
    assert np.array_equal(got, np.asarray(ref_h.dequantize_int8(rq, rs)))
    # the round trip is within half a step
    assert np.abs(got - x).max() <= float(s) * 0.51 + 1e-9


def test_quantize_matches_on_the_world(world):
    xs, _ = _inputs()
    rq, rs = ref_h.quantize_int8(jnp.asarray(xs[0]))
    for rank in world:
        q, s = rank["quant"]
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)


def test_flat_and_hierarchical_allreduce_equal_the_literal_sum(world):
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    want = x.reshape(4, 2, 4).sum(0)
    for rank in world:
        np.testing.assert_allclose(rank["flat"].numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(rank["hier"].numpy(),
                                   rank["flat"].numpy(), rtol=1e-6)


@pytest.mark.parametrize("path", ["exchange", "ring"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_all_reduce_on_both_sides_of_the_exchange_bound(world, path, op):
    """At ``EXCHANGE_BYTES`` gloo's all-reduce is the exchange: the sum
    in rank order, in bits; one element over, gloo's ring: the sum within
    fp32 rounding.  Either way every rank holds the same bits."""
    n = h.EXCHANGE_BYTES // 4 + (path == "ring")
    xs = [np.random.default_rng(r).standard_normal(n).astype(np.float32)
          for r in range(4)]
    if op == "max":
        want = np.maximum.reduce(xs)
    else:
        want = xs[0].copy()
        for x in xs[1:]:
            want += x
    got = [rank[f"{path}_{op}"].numpy() for rank in world]
    for g in got:
        assert g.tobytes() == got[0].tobytes()
    if path == "exchange" or op == "max":
        assert got[0].tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)


def test_compressed_cross_pod_mean_matches_reference(world):
    """Each rank passes its pod's vector and residual; the reference
    runs under ``vmap`` with ``axis_name="pod"`` over the stacked pods."""
    xs, rs = _inputs()
    want, want_res = jax.vmap(
        lambda x, r: ref_h.compressed_cross_pod_mean(x, "pod", r),
        axis_name="pod")(jnp.asarray(xs), jnp.asarray(rs))
    want, want_res = np.asarray(want), np.asarray(want_res)
    scale = np.abs(xs + rs).max() / np.float32(127.0) + np.float32(1e-12)
    for r, rank in enumerate(world):
        pod = r // 2
        out, res = (t.numpy() for t in rank["compressed"])
        # the codes: the residual is x + r less code x scale
        codes = np.round((xs[pod] + rs[pod] - res) / scale)
        want_codes = np.round((xs[pod] + rs[pod] - want_res[pod]) / scale)
        assert np.array_equal(codes, want_codes)
        np.testing.assert_allclose(out, want[pod], rtol=0, atol=1e-6)
        np.testing.assert_allclose(res, want_res[pod], rtol=0, atol=1e-6)


def test_error_feedback_mean_converges(world):
    """20 compressed means of the same per-pod vectors, residuals fed
    back: their average approaches the true mean (the reference's
    ``tests/test_hierarchy.py`` bound, 0.02)."""
    xs, _ = _inputs()
    true_mean = xs.mean(axis=0)
    for rank in world:
        np.testing.assert_allclose(rank["ef_avg"].numpy(), true_mean,
                                   atol=0.02)


def test_hierarchical_reduces_cross_pod_bytes(world):
    """The paper's claim, structurally, on the port's own collectives: a
    flat all-reduce of the 1024 x 64 fp32 buffer sends it over a group
    that spans both pods; the hierarchical schedule sends only the
    1/|data| shard across pods, and the int8 codes a quarter of that."""
    for rank in world:
        flat = rank["pod_bytes_flat"]
        hier = rank["pod_bytes_hierarchical"]
        comp = rank["pod_bytes_compress_pod"]
        assert hier < 0.5 * flat, (hier, flat)
        assert 0.24 <= comp / hier <= 0.26, (comp, hier)
        nbytes = 1024 * 64 * 4
        # ring accounting: 2 (n-1)/n of the buffer over the 4-rank group;
        # the shard's all-reduce over 2 pods; the codes' all-gather
        assert flat == 2 * 3 / 4 * nbytes
        assert rank["bytes_hierarchical"]["pod:all-reduce"] == nbytes / 2
        assert rank["bytes_compress_pod"]["pod:all-gather"] == nbytes / 8


def test_layout_coordinates_and_groups():
    """Row-major coordinates, as ``jax.make_mesh`` lays out a device
    list, and the groups each axis makes."""
    lay = mesh_lib.Layout((2, 2, 1), ("pod", "data", "model"))
    assert [tuple(lay.coords(r).values()) for r in range(4)] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert lay.groups(("data",)) == [[0, 1], [2, 3]]
    assert lay.groups(("pod",)) == [[0, 2], [1, 3]]
    assert lay.groups(("pod", "data")) == [[0, 1, 2, 3]]
    assert mesh_lib.grid_axes(lay) == [("pod",), ("data",), ("pod", "data")]
    devices = np.arange(4).reshape(2, 2, 1)
    for r in range(4):
        c = lay.coords(r)
        assert devices[c["pod"], c["data"], c["model"]] == r


def test_backend_rule():
    cpu = torch.device("cpu")
    assert mesh_lib.choose_backend(cpu, 4)[0] == "gloo"
    assert mesh_lib.choose_backend(cpu, 4, "gloo")[0] == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        mesh_lib.choose_backend(cpu, 4, "nccl")
