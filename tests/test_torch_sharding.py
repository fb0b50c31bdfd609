"""Port vs reference: the sharding rule tables.

``repro_torch.sharding`` against ``repro.sharding`` for every config of
both config tables, train and decode shapes at batches 1, 8 and 32
(train also in 2 microbatches where the batch splits), FSDP on and off,
both ``dp_mode``s, on the layouts (2,2,2), (2,2,1), (2,4,1), (4,2) and
(1,1): the rule tables equal, and ``spec``, ``strip_axis``, ``override``
and ``describe`` equal as tuples.  The reference's ``make_rules`` reads
only ``mesh.axis_names`` and ``mesh.devices.shape``, so a stand-in with
those two attributes gives it its mesh in process; the port's reads the
``Layout``.
"""

import types

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS                  # noqa: E402
from repro.configs import SMOKE_ARCHS as REF_SMOKE            # noqa: E402
from repro.models.config import ShapeConfig as RefShape       # noqa: E402
from repro.sharding import partition as ref_partition         # noqa: E402
from repro.sharding import profiles as ref_profiles           # noqa: E402
from repro_torch.configs import ARCHS, SMOKE_ARCHS            # noqa: E402
from repro_torch.launch.mesh import Layout                    # noqa: E402
from repro_torch.models.config import ShapeConfig             # noqa: E402
from repro_torch.sharding import partition, profiles          # noqa: E402

LAYOUTS = [((2, 2, 2), ("pod", "data", "model")),
           ((2, 2, 1), ("pod", "data", "model")),
           ((2, 4, 1), ("pod", "data", "model")),
           ((4, 2), ("data", "model")),
           ((1, 1), ("data", "model"))]
CONFIGS = [(table, arch) for table in ("full", "smoke")
           for arch in (ARCHS if table == "full" else SMOKE_ARCHS)]
# logical-axes tuples the reference's models and states ask for
SPECS = [("batch", "seq_q", "embed"), ("batch", None, "vocab"),
         ("layers", "embed", "ff"), ("layers", "ff", "embed"),
         ("layers", "embed", "qkv_out"), ("layers", "embed", "kv_out"),
         ("batch", "seq_attn", "heads", "head_dim"),
         ("batch", "seq_kv", "kv_heads", "head_dim"),
         ("layers", "expert", "embed", "expert_ff"),
         ("moe_groups", None, "embed"), ("layers", "embed_norm"),
         ("batch", None, "ssm_heads", None), ("ssm_inner_proj",),
         ("ssm_conv_ch", "ssm_inner", "ssm_inner_norm"),
         ("vocab", "embed"), (), (None, None), ("batch", "batch"),
         ("embed", "embed", "ff", "ff")]


def _shapes():
    for batch in (1, 8, 32):
        yield ("train", batch, 1)
        if batch % 2 == 0:
            yield ("train", batch, 2)
        yield ("decode", batch, 1)


def _tables():
    for table, arch in CONFIGS:
        ref = (REF_ARCHS if table == "full" else REF_SMOKE)[arch]
        port = (ARCHS if table == "full" else SMOKE_ARCHS)[arch]
        yield table, arch, ref, port


def _pair(shape, axes):
    stand_in = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape))
    return stand_in, Layout(shape, axes)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda la: "x".join(
    map(str, la[0])))
@pytest.mark.parametrize("table,arch", CONFIGS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_make_rules_matches_reference(table, arch, layout):
    ref_cfg = (REF_ARCHS if table == "full" else REF_SMOKE)[arch]
    cfg = (ARCHS if table == "full" else SMOKE_ARCHS)[arch]
    ref_mesh, mesh = _pair(*layout)
    for kind, batch, micro in _shapes():
        rs = RefShape("s", kind, 64, batch, microbatches=micro)
        ps = ShapeConfig("s", kind, 64, batch, microbatches=micro)
        for fsdp in (True, False):
            for mode in ("auto", "hierarchical"):
                want = ref_profiles.make_rules(ref_cfg, rs, ref_mesh,
                                               fsdp=fsdp, dp_mode=mode)
                got = profiles.make_rules(cfg, ps, mesh, fsdp=fsdp,
                                          dp_mode=mode)
                case = (kind, batch, micro, fsdp, mode)
                assert got.table == want.table, case
                assert profiles.describe(got) == ref_profiles.describe(want)
                for axes in SPECS:
                    assert got.spec(*axes) == tuple(want.spec(*axes)), (
                        case, axes)
                for axis in ("pod", "data", "model"):
                    assert got.strip_axis(axis).table == want.strip_axis(
                        axis).table, (case, axis)
                over = {"batch": None, "embed": ("pod", "data"),
                        "ff": "data"}
                assert got.override(**over).table == want.override(
                    **over).table
                for axes in SPECS:
                    assert got.override(**over).spec(*axes) == tuple(
                        want.override(**over).spec(*axes))


def test_hierarchical_unsafe_is_none_in_the_port():
    """The reference refuses parametric-norm archs only on jax 0.4.x's
    XLA; the port compiles no XLA program."""
    for _, _, _, port in _tables():
        assert profiles.hierarchical_unsafe(port) is None


def test_use_rules_scopes_the_current_rules():
    rules = partition.Rules({"batch": ("pod", "data")})
    assert partition.current_rules() is None
    with partition.use_rules(rules):
        assert partition.current_rules() is rules
        with partition.use_rules(None):
            assert partition.current_rules() is None
        assert partition.current_rules() is rules
    assert partition.current_rules() is None
    ref_rules = ref_partition.Rules({"batch": ("pod", "data")})
    assert rules.spec("batch", "batch") == tuple(ref_rules.spec("batch",
                                                                "batch"))


def test_grid_refusal_names_the_next_slice():
    layout = Layout((2, 2), ("data", "model"))
    assert "tensor parallelism" in profiles.grid_refusal(layout, None)
    flat = Layout((2, 2, 1), ("pod", "data", "model"))
    assert profiles.grid_refusal(flat, None) is None
    fsdp = profiles.make_rules(SMOKE_ARCHS["olmo-1b"],
                               ShapeConfig("s", "train", 32, 8), flat)
    assert "FSDP" in profiles.grid_refusal(flat, fsdp)
    assert profiles.grid_refusal(flat, profiles.make_rules(
        SMOKE_ARCHS["olmo-1b"], ShapeConfig("s", "train", 32, 8), flat,
        fsdp=False)) is None
