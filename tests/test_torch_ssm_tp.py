"""The pieces of the ssm and hybrid families' sharding, on the CPU:

* ``param_axes`` and ``cache_axes`` of mamba2-780m and zamba2-7b (smoke
  and full) carry the reference's logical names leaf for leaf (the
  port's lists have no leading ``("layers",)`` axes), and the blocks the
  port cuts on (data 2, model 2) are the reference's ``PartitionSpec``
  of each leaf, FSDP on;
* under a plan the caches hold the rank's SSD heads, its heads' x
  channels with all of B and C, and its kv heads;
* the mamba2 block on a 2-rank ``model`` world in fp32 (a world of
  ``tests/_dist_world.py``) equals the one-process block: the prefill's
  output, its gradients of the input and of every leaf's block (the
  gathered ``in_proj`` output and conv weights' reduce-scatter, the
  gated norm's sum of squares summed both ways, the norm scale's
  gradient summed over ``model``), the rank's states, and a decode step
  from them, which takes three collectives over ``model``.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS                  # noqa: E402
from repro.configs import SMOKE_ARCHS as REF_SMOKE            # noqa: E402
from repro.models import hybrid as ref_hybrid                 # noqa: E402
from repro.models import mamba2 as ref_mamba2                 # noqa: E402
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

CASES = [(arch, smoke) for arch in ("mamba2-780m", "zamba2-7b")
         for smoke in (True, False)]
LEAD = {"layers": 1, "mamba_main": 2, "mamba_tail": 1}


def _walk(t, prefix, out):
    if ref_partition.is_axes_leaf(t):
        out[prefix] = t
    else:
        for k in sorted(t):
            _walk(t[k], f"{prefix}/{k}" if prefix else k, out)
    return out


@pytest.mark.parametrize("arch,smoke", CASES)
def test_axes_trees_match_the_reference(arch, smoke):
    cfg = (SMOKE_ARCHS if smoke else ARCHS)[arch]
    ref_cfg = (REF_SMOKE if smoke else REF_ARCHS)[arch]
    ref_mod = ref_mamba2 if cfg.family == "ssm" else ref_hybrid
    model = build_model(cfg, device="cpu")
    port = dict(partition.named_axes(model.param_axes()))
    ref = _walk(ref_mod.param_axes(ref_cfg), "", {})
    assert port.keys() == ref.keys()
    for name, axes in port.items():
        assert axes == ref[name][LEAD.get(name.split("/")[0], 0):], name
    want = (ref_mamba2.cache_axes() if cfg.family == "ssm"
            else ref_hybrid.cache_axes(ref_cfg))
    assert model.cache_axes() == want
    layout = Layout((2, 2), ("data", "model"))
    rules = profiles.make_rules(cfg, ShapeConfig("s", "train", 32, 8),
                                layout)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((2, 2)))
    ref_rules = ref_profiles.make_rules(ref_cfg, RefShape("s", "train", 32,
                                                          8), mesh)
    for name, axes in port.items():
        spec = tuple(ref_rules.spec(*ref[name]))
        spec = spec[LEAD.get(name.split("/")[0], 0):]
        block = partition.block_of(layout, layout.coords(3), rules, axes)
        assert block.axes == tuple(() if e is None else
                                   ((e,) if isinstance(e, str) else tuple(e))
                                   for e in spec), name


@pytest.mark.parametrize("arch,m", [("mamba2-780m", 2), ("mamba2-780m", 4),
                                    ("zamba2-7b", 2), ("zamba2-7b", 4)])
def test_cache_holds_the_rank_heads_and_channels(arch, m):
    """A rank's cache under the session's rules (no collective runs to
    make one)."""
    cfg = SMOKE_ARCHS[arch]
    layout = Layout((1, m), ("data", "model"))
    grid = RankGrid(layout, 0, torch.device("cpu"))
    rules = profiles.make_rules(cfg, ShapeConfig("s", "decode", 16, 2),
                                layout, fsdp=False)
    model = build_model(cfg, device="cpu")
    whole = model.init_cache(2, 16, dtype=torch.float32)
    with partition.use_rules(rules, grid):
        got = model.init_cache(2, 16, dtype=torch.float32)
    GN = cfg.ssm_n_groups * cfg.ssm_state
    for k, t in whole.items():
        want = list(t.shape)
        if k.startswith("conv"):
            want[-1] = cfg.d_inner // m + 2 * GN
        elif k.startswith("ssd"):
            want[-3] //= m
        else:                                        # k, v
            want[-2] //= m
        assert tuple(got[k].shape) == tuple(want), k


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    d = tmp_path_factory.mktemp("ssm_block")
    run_world(2, "ssm_block", d)
    return [load(d, "ssm_block", r) for r in range(2)]


@pytest.mark.parametrize("piece", ["prefill", "states", "decode"])
def test_sharded_block_equals_one_process(block, piece):
    for rank in block:
        for name, got, want in rank[piece]:
            assert got.shape == want.shape, (piece, name)
            top = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= 1e-5 * max(top, 1e-30), (piece, name, err, top)


def test_a_decode_step_takes_three_collectives_over_model(block):
    for rank in block:
        assert rank["decode_stats"] == {"model:all-gather:ssm": 1,
                                        "model:all-reduce:ssm": 1,
                                        "model:all-reduce:ssm-norm": 1}
