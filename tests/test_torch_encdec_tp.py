"""The pieces of the encdec family's sharding, on the CPU:

* ``param_axes`` of whisper-small (smoke and full) carries the
  reference's logical names leaf for leaf (the port's lists have no
  leading ``("layers",)`` axis), and the blocks the port cuts on (data
  2, model 2) with FSDP are the reference's ``PartitionSpec`` of each
  leaf;
* under a plan the cache holds the rank's kv heads;
* on a 2-rank ``model`` world in fp32 (a world of
  ``tests/_dist_world.py``) the encoder block, the decoder block over
  ``cross_kv`` and the decoder block over a cache equal the one-process
  blocks: outputs, the gradients of the input, of the encoder states
  (behind one ``copy_to_model``) and of every leaf's block, and the
  rank's kv heads of the cache; the whole model's loss and gradients
  too;
* the encoder states' gradient is summed over ``model`` once a step
  (one ``cross`` all-reduce, whatever the decoder's depth), and a
  decode step takes one all-reduce for the lookup and three a decoder
  layer.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS                  # noqa: E402
from repro.configs import SMOKE_ARCHS as REF_SMOKE            # noqa: E402
from repro.models import encdec as ref_encdec                 # noqa: E402
from repro.models.config import ShapeConfig as RefShape       # noqa: E402
from repro.sharding import partition as ref_partition         # noqa: E402
from repro.sharding import profiles as ref_profiles           # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import load, run_world                       # noqa: E402

from repro_torch.configs import ARCHS, SMOKE_ARCHS            # noqa: E402
from repro_torch.launch.mesh import Layout, RankGrid          # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.models.config import ShapeConfig             # noqa: E402
from repro_torch.sharding import partition, profiles          # noqa: E402

LEAD = {"enc_layers": 1, "dec_layers": 1}


def _walk(t, prefix, out):
    if ref_partition.is_axes_leaf(t):
        out[prefix] = t
    else:
        for k in sorted(t):
            _walk(t[k], f"{prefix}/{k}" if prefix else k, out)
    return out


def _spec_axes(spec):
    return tuple(() if e is None else ((e,) if isinstance(e, str)
                                       else tuple(e)) for e in spec)


@pytest.mark.parametrize("smoke", [True, False])
def test_axes_tree_and_blocks_match_the_reference(smoke):
    cfg = (SMOKE_ARCHS if smoke else ARCHS)["whisper-small"]
    ref_cfg = (REF_SMOKE if smoke else REF_ARCHS)["whisper-small"]
    model = build_model(cfg, device="cpu")
    port = dict(partition.named_axes(model.param_axes()))
    ref = _walk(ref_encdec.param_axes(ref_cfg), "", {})
    assert port.keys() == ref.keys()
    for name, axes in port.items():
        assert axes == ref[name][LEAD.get(name.split("/")[0], 0):], name
    assert model.cache_axes() == ref_encdec.cache_axes()
    layout = Layout((2, 2), ("data", "model"))
    shape = ShapeConfig("s", "train", 32, 8)
    rules = profiles.make_rules(cfg, shape, layout, fsdp=True)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((2, 2)))
    ref_rules = ref_profiles.make_rules(ref_cfg, RefShape("s", "train", 32,
                                                          8), mesh)
    for name, axes in port.items():
        spec = tuple(ref_rules.spec(*ref[name]))
        spec = spec[LEAD.get(name.split("/")[0], 0):]
        for coords in range(4):
            block = partition.block_of(layout, layout.coords(coords), rules,
                                       axes)
            assert block.axes == _spec_axes(spec), name
    # FSDP splits the projections' embed rows over data, the heads their
    # columns over model; the LayerNorms stay whole
    named = dict(port)
    assert partition.block_of(layout, layout.coords(3), rules, named[
        "dec_layers/cross_attn/wk"]).axes == (("data",), ("model",))
    assert partition.block_of(layout, layout.coords(3), rules, named[
        "enc_norm/scale"]).whole


@pytest.mark.parametrize("m", [2, 4])
def test_cache_holds_the_rank_kv_heads(m):
    cfg = SMOKE_ARCHS["whisper-small"]
    layout = Layout((1, m), ("data", "model"))
    grid = RankGrid(layout, 0, torch.device("cpu"))
    rules = profiles.make_rules(cfg, ShapeConfig("s", "decode", 16, 2),
                                layout, fsdp=False)
    model = build_model(cfg, device="cpu")
    with partition.use_rules(rules, grid):
        got = model.init_cache(2, 16, dtype=torch.float32)
    want = (cfg.n_layers, 2, 16, cfg.n_kv_heads // m, cfg.head_dim)
    assert {k: tuple(v.shape) for k, v in got.items()} == {"k": want,
                                                           "v": want}


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    d = tmp_path_factory.mktemp("encdec_block")
    run_world(2, "encdec_block", d)
    return [load(d, "encdec_block", r) for r in range(2)]


@pytest.mark.parametrize("piece", ["encoder", "decoder", "cache", "model",
                                   "decode"])
def test_sharded_blocks_equal_one_process(block, piece):
    """Each within 1e-5 of its largest |value|; a key bias's gradient,
    exactly zero (an attention without RoPE is blind to it), within
    1e-5 of the piece's largest gradient on both sides (the rule of
    ``tests/test_torch_train_families.py``)."""
    for rank in block:
        assert rank[piece]
        grads = max(float(w.abs().max()) for n, _, w in rank[piece]
                    if n not in ("out", "loss"))
        for name, got, want in rank[piece]:
            assert got.shape == want.shape, (piece, name)
            if name.endswith("bk") and piece in ("encoder", "decoder",
                                                 "model"):
                assert max(float(got.abs().max()), float(
                    want.abs().max())) <= 1e-5 * grads, (piece, name)
                continue
            top = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= 1e-5 * max(top, 1e-30), (piece, name, err, top)


def test_encoder_states_gradient_is_summed_once_a_step(block):
    """One ``cross`` all-reduce in the loss's backward for the two
    decoder layers' cross K/V, and none in the forward."""
    cfg = SMOKE_ARCHS["whisper-small"]
    assert cfg.n_layers == 2
    for rank in block:
        assert rank["loss_stats"]["model:all-reduce:cross"] == 1
        names = dict((n, g) for n, g, _ in rank["decoder"])
        assert "enc_states" in names


def test_a_decode_step_takes_the_lookup_and_three_sums_a_layer(block):
    cfg = SMOKE_ARCHS["whisper-small"]
    for rank in block:
        assert rank["decode_stats"] == {
            "model:all-reduce": 1 + 3 * cfg.n_layers}
