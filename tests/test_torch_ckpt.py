"""The port's checkpoint store against the reference's, on the CPU.

``repro_torch.ckpt.checkpoint`` writes the reference's on-disk format
(``repro.ckpt.checkpoint``): the same leaf names, stacked ``(L, ...)``
shapes, files and checksums.  fp32 parameter and optimizer trees saved
by one package restore in the other with equal tensors, and the two
manifests carry equal checksums.  bf16 leaves restore port to port in
bits; corruption is detected; an asynchronous save commits.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro.ckpt import checkpoint as ref_ckpt                 # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.optim.adamw import AdamW as RefAdamW               # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt               # noqa: E402
from repro_torch.optim.adamw import AdamW                     # noqa: E402
from repro_torch.tree import tree_leaves, tree_map            # noqa: E402

# the dense families' layer list, the moe experts' (L, E, ...) leaves and
# the hybrid's two-deep (groups, per, ...) mamba stack
ARCHS = ["olmo-1b", "qwen1.5-0.5b", "olmoe-1b-7b", "zamba2-7b"]


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    """The reference's params and moments (made non-zero by one update),
    as numpy."""
    params = ref_build(SMOKE_ARCHS[arch]).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params)
    params, state, _ = jax.jit(RefAdamW().update)(
        grads, RefAdamW().init(params), params)
    return jax.tree.map(np.asarray, {"params": params, "mu": state.mu,
                                     "nu": state.nu})


def _trees(arch):
    """The reference's trees and the port's same trees (the bridge)."""
    ref = _ref_trees(arch)
    port = {k: bridge.params_from_reference(v, "cpu") for k, v in ref.items()}
    return ref, port


def _checksums(path):
    return {name: [s["checksum"] for s in meta["shards"]]
            for name, meta in ckpt.load_manifest(path)["leaves"].items()}


def _same(ref_tree, port_tree):
    got = {k: bridge.params_to_reference(v) for k, v in port_tree.items()}
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    for path, want in flat:
        node = got
        for k in path:
            node = node[k.key]
        assert node.shape == want.shape and (node == want).all(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_save_restores_in_the_port(tmp_path, arch):
    ref, port = _trees(arch)
    ref_ckpt.save(tmp_path / "ck", jax.tree.map(jax.numpy.asarray, ref),
                  step=7, extra={"pipeline": {"step": 7, "seed": 0}}).wait()
    zeros = tree_map(torch.zeros_like, port)
    tree, meta = ckpt.restore(tmp_path / "ck", zeros)
    assert meta == {"step": 7, "pipeline": {"step": 7, "seed": 0}}
    _same(ref, tree)
    # the port writes the same files: same names, same checksums
    ckpt.save(tmp_path / "port", tree, step=7).wait()
    assert _checksums(tmp_path / "port") == _checksums(tmp_path / "ck")


@pytest.mark.parametrize("arch", ARCHS)
def test_port_save_restores_in_the_reference(tmp_path, arch):
    ref, port = _trees(arch)
    ckpt.save(tmp_path / "ck", port, step=3, extra={"note": "port"}).wait()
    zeros = jax.tree.map(np.zeros_like, ref)
    tree, meta = ref_ckpt.restore(tmp_path / "ck", zeros)
    assert meta == {"step": 3, "note": "port"}
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                              jax.tree_util.tree_flatten_with_path(ref)[0]):
        assert a.dtype == b.dtype and (np.asarray(a) == b).all(), p
    ref_ckpt.save(tmp_path / "ref", tree, step=3).wait()
    assert _checksums(tmp_path / "ref") == _checksums(tmp_path / "ck")


def test_bf16_and_int_leaves_round_trip_in_bits(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": [torch.randn(3, 5, generator=g).to(torch.bfloat16)
                  for _ in range(2)],
            "b": torch.randn(7, generator=g).to(torch.bfloat16),
            "step": torch.tensor(11, dtype=torch.int32),
            "f": torch.randn(4, generator=g)}
    ckpt.save(tmp_path / "ck", tree, step=1).wait()
    leaves = ckpt.load_manifest(tmp_path / "ck")["leaves"]
    assert leaves["w"]["global_shape"] == [2, 3, 5]
    assert leaves["w"]["dtype"] == leaves["b"]["dtype"] == "bfloat16"
    got, _ = ckpt.restore(tmp_path / "ck", tree_map(torch.zeros_like, tree))
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_one_layer_list_keeps_its_layer_axis(tmp_path):
    tree = {"layers": [{"w": torch.arange(6.0).reshape(2, 3)}]}
    ckpt.save(tmp_path / "ck", tree, step=0).wait()
    meta = ckpt.load_manifest(tmp_path / "ck")["leaves"]["layers/w"]
    assert meta["global_shape"] == [1, 2, 3]
    got, _ = ckpt.restore(tmp_path / "ck", tree)
    assert torch.equal(got["layers"][0]["w"], tree["layers"][0]["w"])


def test_corruption_is_detected(tmp_path):
    _, port = _trees("olmo-1b")
    ckpt.save(tmp_path / "ck", port, step=1).wait()
    meta = ckpt.load_manifest(tmp_path / "ck")["leaves"]["mu/layers/mlp/w_up"]
    f = tmp_path / "ck" / meta["shards"][0]["file"]
    arr = np.load(f)
    arr.flat[5] += 1.0
    np.save(f, arr)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(tmp_path / "ck", port)
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(tmp_path / "ck", {"extra": torch.zeros(2)})
    # the reference detects the port's corrupted file as well
    ref, _ = _trees("olmo-1b")
    with pytest.raises(IOError, match="checksum"):
        ref_ckpt.restore(tmp_path / "ck", ref)


def test_async_save_commits_and_replaces(tmp_path):
    _, port = _trees("qwen1.5-0.5b")
    h = ckpt.save(tmp_path / "ck", port, step=3, asynchronous=True)
    h.wait()
    assert h.done and h.error is None
    assert not (tmp_path / "ck.tmp0").exists()
    # a second save of the same directory replaces the first atomically
    later = tree_map(lambda t: t + 1, port)
    ckpt.save(tmp_path / "ck", later, step=4, asynchronous=True).wait()
    got, meta = ckpt.restore(tmp_path / "ck", port)
    assert meta["step"] == 4
    for a, b in zip(tree_leaves(later), tree_leaves(got)):
        assert torch.equal(a, b)


def test_adamw_state_saves_with_its_step(tmp_path):
    _, port = _trees("olmo-1b")
    opt = AdamW()
    state = opt.init(port["params"])
    ckpt.save(tmp_path / "ck", state, step=0).wait()
    names = set(ckpt.load_manifest(tmp_path / "ck")["leaves"])
    assert {"step", "mu/embedding/table", "nu/layers/attn/wq"} <= names
    got, _ = ckpt.restore(tmp_path / "ck", state)
    assert type(got) is type(state) and got.step.dtype == torch.int32
