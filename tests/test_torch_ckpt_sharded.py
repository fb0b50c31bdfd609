"""Sharded checkpoints in the reference's manifest format, both ways,
on the CPU (qwen1.5-0.5b smoke, fp32; worlds of ``tests/_dist_world.py``).

* The port's checkpoint written from a 4-rank ``(data 2, model 2)``
  world with FSDP (one step in, so the moments are not zero): rank 0
  writes every distinct block once with its ``index``; the reference's
  ``repro.ckpt.checkpoint.restore`` reads it and equals the state
  gathered from the ranks, in bits.
* A checkpoint the reference saves from its own sharded mesh (four
  forced host devices, ``(data 2, model 2)``, FSDP rules, the state
  ``device_put`` to its shardings): the port's ``elastic.replan`` reads
  it onto ``(data 2, model 2)`` with FSDP, ``(pod 2, data 1, model 2)``
  and one rank, each rank's block of each leaf equal in bits to that
  block of the reference's arrays.
* 4 ranks -> 2 -> 1: the port's 4-rank checkpoint replanned onto 2
  ranks ``(data 1, model 2)``, saved again from there, and read by one
  rank, in bits.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.ckpt import checkpoint as ref_ckpt                 # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import load, run_world                       # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen1.5-0.5b"

REFERENCE_SAVE = """
import pickle, sys
from pathlib import Path
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.ckpt import checkpoint as ckpt
from repro.configs import SMOKE_ARCHS
from repro.models.api import build_model
from repro.models.config import ShapeConfig
from repro.sharding.partition import tree_shardings
from repro.sharding.profiles import make_rules

root = Path(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
cfg = SMOKE_ARCHS["qwen1.5-0.5b"]
model = build_model(cfg)
rules = make_rules(cfg, ShapeConfig("t", "train", 32, 8), mesh, fsdp=True)
tree = {k: model.init(jax.random.PRNGKey(i))
        for i, k in enumerate(("params", "mu", "nu"))}
pa = model.param_axes()
tree = jax.device_put(tree, tree_shardings(
    mesh, rules, {"params": pa, "mu": pa, "nu": pa}))
ckpt.save(root / "ref_ckpt", tree, step=5, extra={"by": "reference"}).wait()
with open(root / "ref_full.pkl", "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, tree), f)
print("OK")
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_sharded")
    params = ref_build(SMOKE_ARCHS[ARCH]).init(jax.random.PRNGKey(0))
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    rng = np.random.default_rng(5)
    vocab = SMOKE_ARCHS[ARCH].vocab
    np.savez(d / "inputs.npz",
             tokens=rng.integers(0, vocab, (1, 8, 32)).astype(np.int32),
             labels=rng.integers(0, vocab, (1, 8, 32)).astype(np.int32))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run([sys.executable, "-c", textwrap.dedent(
        REFERENCE_SAVE), str(d)], env=env, capture_output=True, text=True,
        timeout=300)
    assert ref.returncode == 0 and "OK" in ref.stdout, ref.stderr[-4000:]
    run_world(4, "ckpt_write", d, layout="2x2", fsdp=True, name="port4")
    run_world(2, "ckpt_read", d, layout="1x2", fsdp=False, src="port4",
              write="port2")
    run_world(1, "ckpt_read", d, layout="1", fsdp=False, src="port2")
    for layout, fsdp, n in (("2x2", True, 4), ("2x1x2", False, 4),
                            ("1", False, 1)):
        run_world(n, "ckpt_read", d, layout=layout, fsdp=fsdp,
                  src="ref_ckpt")
    return d


def _ref_tree(state):
    """The reference's ``{"params", "mu", "nu"}`` tree shape for its
    restore (the reference's smoke parameters, values unused)."""
    return {k: jax.tree.map(jnp.asarray, state) for k in ("params", "mu",
                                                          "nu")}


def _by_name(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_by_name(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def test_reference_restore_reads_the_port_sharded_checkpoint(worlds):
    d = worlds
    manifest = json.loads((d / "port4" / "manifest.p0.json").read_text())
    wq = manifest["leaves"]["params/layers/attn/wq"]
    assert [s["index"] for s in wq["shards"]] == [
        [[None, None, None], [a, a + 32, None], [b, b + 32, None]]
        for a in (0, 32) for b in (0, 32)]
    norm = manifest["leaves"]["params/final_norm/scale"]["shards"]
    assert [s["index"] for s in norm] == [[[None, None, None]]]
    with open(d / "params.pkl", "rb") as f:
        like = pickle.load(f)
    tree, extra = ref_ckpt.restore(d / "port4", _ref_tree(like))
    assert extra["step"] == 1 and extra["by"] == "2x2"
    want = load(d, "ckpt_full_port4", 0)
    got = _by_name(jax.tree.map(np.asarray, tree))
    full = _by_name(want)
    assert got.keys() == full.keys()
    for name in full:
        assert got[name].dtype == full[name].dtype
        assert np.array_equal(got[name], full[name]), name


def _check_blocks(rank, full):
    """Each restored leaf (the port's per-layer tensors) equals its block
    of the full (stacked) array."""
    from repro_torch.tree import leaf_groups
    leaves = {n: (ts, lead) for n, ts, lead in leaf_groups(rank["restored"])}
    blocks = {n: bs for n, bs, _ in leaf_groups(rank["blocks"])}
    assert leaves.keys() == full.keys()
    for name, (ts, lead) in leaves.items():
        whole = full[name].reshape((-1,) + full[name].shape[len(lead):])
        for i, (t, b) in enumerate(zip(ts, blocks[name])):
            part = whole[i] if lead else full[name]
            want = part[b.slices(part.shape)]
            assert np.array_equal(t.numpy(), want), name


@pytest.mark.parametrize("layout,n", [("2x2", 4), ("2x1x2", 4), ("1", 1)])
def test_port_replan_reads_the_reference_sharded_checkpoint(worlds, layout,
                                                            n):
    d = worlds
    manifest = json.loads((d / "ref_ckpt" / "manifest.p0.json").read_text())
    assert len(manifest["leaves"]["params/layers/attn/wq"]["shards"]) == 4
    with open(d / "ref_full.pkl", "rb") as f:
        full = _by_name(pickle.load(f))
    for r in range(n):
        rank = load(d, f"ckpt_read_ref_ckpt_{layout}", r)
        assert rank["step"] == 5
        _check_blocks(rank, full)


def test_four_ranks_to_two_to_one_in_bits(worlds):
    d = worlds
    full = _by_name(load(d, "ckpt_full_port4", 0))
    for src, layout, n in (("port4", "1x2", 2), ("port2", "1", 1)):
        for r in range(n):
            rank = load(d, f"ckpt_read_{src}_{layout}", r)
            assert rank["step"] == 1
            _check_blocks(rank, full)
    manifest = json.loads((d / "port2" / "manifest.p0.json").read_text())
    wq = manifest["leaves"]["params/layers/attn/wq"]["shards"]
    assert [s["index"][2] for s in wq] == [[0, 32, None], [32, 64, None]]
