"""Sharded checkpoints of the encdec tree in the reference's manifest
format, both ways, on the CPU (whisper-small smoke, fp32; worlds of
``tests/_dist_world.py``), as ``tests/test_torch_ckpt_sharded.py`` holds
the dense tree:

* the port's checkpoint written from a 4-rank ``(data 2, model 2)``
  world with FSDP, one step in (its batch carries ``frame_embeds``):
  the cross-attention's ``wk`` in four blocks (``embed`` over ``data``,
  ``kv_out`` over ``model``), ``bk`` the ``model`` rank's heads, the
  LayerNorms whole; the reference's ``restore`` reads it and equals the
  state gathered from the ranks, in bits;
* a checkpoint the reference saves from its own sharded mesh (FSDP
  rules, ``(data 2, model 2)``): the port's ``elastic.replan`` reads it
  onto ``(data 2, model 2)`` with FSDP, ``(pod 2, data 1, model 2)`` and
  one rank, each block equal in bits to the reference's;
* 4 ranks -> 2 -> 1 through the port's own checkpoints, in bits.
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

from repro.ckpt import checkpoint as ref_ckpt                 # noqa: E402
from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import load, run_world                       # noqa: E402
from test_torch_ckpt_sharded import (REFERENCE_SAVE, ROOT,    # noqa: E402
                                     _by_name, _check_blocks, _ref_tree)

ARCH = "whisper-small"
WK = "params/dec_layers/cross_attn/wk"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_encdec")
    cfg = SMOKE_ARCHS[ARCH]
    params = ref_build(cfg).init(jax.random.PRNGKey(0))
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    rng = np.random.default_rng(5)
    np.savez(d / "inputs.npz",
             tokens=rng.integers(0, cfg.vocab, (1, 8, 32)).astype(np.int32),
             labels=rng.integers(0, cfg.vocab, (1, 8, 32)).astype(np.int32),
             frames=rng.standard_normal(
                 (1, 8, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = textwrap.dedent(REFERENCE_SAVE).replace(
        'SMOKE_ARCHS["qwen1.5-0.5b"]', f'SMOKE_ARCHS["{ARCH}"]')
    ref = subprocess.Popen([sys.executable, "-c", script, str(d)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        run_world(4, "ckpt_write", d, layout="2x2", fsdp=True, name="port4",
                  arch=ARCH)
        run_world(2, "ckpt_read", d, layout="1x2", fsdp=False, src="port4",
                  write="port2", arch=ARCH)
        run_world(1, "ckpt_read", d, layout="1", fsdp=False, src="port2",
                  arch=ARCH)
        out, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "OK" in out, out[-4000:]
    for layout, fsdp, n in (("2x2", True, 4), ("2x1x2", False, 4),
                            ("1", False, 1)):
        run_world(n, "ckpt_read", d, layout=layout, fsdp=fsdp,
                  src="ref_ckpt", arch=ARCH)
    return d


def test_reference_restore_reads_the_port_sharded_checkpoint(worlds):
    d = worlds
    cfg = SMOKE_ARCHS[ARCH]
    half, cols = cfg.d_model // 2, cfg.n_kv_heads * cfg.head_dim // 2
    manifest = json.loads((d / "port4" / "manifest.p0.json").read_text())
    assert [s["index"] for s in manifest["leaves"][WK]["shards"]] == [
        [[None, None, None], [b, b + half, None], [c, c + cols, None]]
        for b in (0, half) for c in (0, cols)]
    bk = manifest["leaves"][WK.replace("wk", "bk")]["shards"]
    assert [s["index"] for s in bk] == [
        [[None, None, None], [c, c + cols, None]] for c in (0, cols)]
    norm = manifest["leaves"]["params/enc_norm/scale"]["shards"]
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


@pytest.mark.parametrize("layout,n", [("2x2", 4), ("2x1x2", 4), ("1", 1)])
def test_port_replan_reads_the_reference_sharded_checkpoint(worlds, layout,
                                                            n):
    d = worlds
    manifest = json.loads((d / "ref_ckpt" / "manifest.p0.json").read_text())
    assert len(manifest["leaves"][WK]["shards"]) == 4
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
    cfg = SMOKE_ARCHS[ARCH]
    cols = cfg.n_kv_heads * cfg.head_dim // 2
    shards = manifest["leaves"][WK]["shards"]
    assert [s["index"][-1] for s in shards] == [[0, cols, None],
                                                [cols, 2 * cols, None]]
