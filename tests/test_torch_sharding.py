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
    """Tensor parallelism and FSDP run the dense family's step; what
    ``grid_refusal`` leaves to a later slice is narrowed to heads that do
    not divide the ``model`` axis, the other families under a ``model``
    axis or FSDP, and serving under a ``model`` axis."""
    shape = ShapeConfig("s", "train", 32, 8)
    layout = Layout((2, 2), ("data", "model"))
    flat = Layout((2, 2, 1), ("pod", "data", "model"))
    dense = SMOKE_ARCHS["olmo-1b"]
    for grid in (layout, flat):
        for fsdp in (False, True):
            rules = profiles.make_rules(dense, shape, grid, fsdp=fsdp)
            assert profiles.grid_refusal(grid, rules, dense) is None
    assert profiles.grid_refusal(layout, None) is None
    for arch, what in (("olmoe-1b-7b", "expert parallelism"),
                       ("mamba2-780m", "ssm_*"), ("zamba2-7b", "ssm_*"),
                       ("whisper-small", "encoder-decoder")):
        cfg = SMOKE_ARCHS[arch]
        why = profiles.grid_refusal(layout, profiles.make_rules(
            cfg, shape, layout, fsdp=False), cfg)
        assert "tensor parallelism" in why and what in why, why
        why = profiles.grid_refusal(flat, profiles.make_rules(
            cfg, shape, flat), cfg)
        assert "FSDP" in why and "later slice" in why, why
        assert profiles.grid_refusal(flat, profiles.make_rules(
            cfg, shape, flat, fsdp=False), cfg) is None
    eight = Layout((1, 8), ("data", "model"))
    why = profiles.grid_refusal(eight, profiles.make_rules(
        dense, shape, eight, fsdp=False), dense)
    assert "seq_attn" in why and "later slice" in why
    assert "serving" in profiles.grid_refusal(layout, None, serving=True)
    assert profiles.grid_refusal(flat, None, serving=True) is None


@pytest.mark.parametrize("entry", ["engine", "session"])
def test_serving_refuses_a_lease_with_a_model_axis(entry, monkeypatch):
    """``Engine.from_lease`` and ``runtime.serve.make_lease_session`` ask
    ``grid_refusal(..., serving=True)`` on the mesh their lease binds: one
    device (the CLI's) has no ``model`` axis over 1 and serves; a lease
    with ``model_parallel`` 2 bound to two devices is refused, naming the
    later slice, where the engine would otherwise serve on the first
    device alone."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.pool import smoke_pool
    from repro_torch.pool.lease import Lease
    from repro_torch.runtime.serve import make_lease_session
    from repro_torch.serve import Engine, EngineConfig

    model = build_model(SMOKE_ARCHS["qwen1.5-0.5b"], device="cpu")
    lease = smoke_pool("scalepool").lease("serve", 4, model_parallel=2)

    def bind(**kw):
        if entry == "engine":
            return Engine.from_lease(
                model, lease, EngineConfig(max_slots=2, max_seq=64),
                generator=torch.Generator().manual_seed(0), **kw)
        return make_lease_session(model, ShapeConfig("s", "decode", 64, 2),
                                  lease, **kw)

    bound = bind(device="cpu")
    assert bound is not None
    one = Lease.materialize
    monkeypatch.setattr(Lease, "materialize",
                        lambda self, devices=None: one(self, ["cpu", "cpu"]))
    assert lease.materialize().shape == (1, 2)
    with pytest.raises(ValueError, match="serving under a model axis of 2"):
        bind()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmo-1b", "qwen3-14b",
                                  "command-r-plus-104b"])
def test_axes_trees_match_the_reference(arch):
    """``transformer.param_axes`` (and ``Model.param_axes``, ``AdamW.
    state_axes``) carry the reference's logical names leaf for leaf: the
    port's ``layers`` is a list of block trees, the reference's one
    stacked tree with a leading ``("layers",)`` axis; and the blocks the
    port cuts are the reference's ``PartitionSpec`` of each leaf."""
    from repro.models import transformer as ref_tf
    from repro.optim.adamw import AdamW as RefAdamW
    from repro_torch.models import transformer as tf
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    cfg, ref_cfg = SMOKE_ARCHS[arch], REF_SMOKE[arch]
    port = dict(partition.named_axes(tf.param_axes(cfg)))
    ref = {}

    def walk(t, prefix):
        if ref_partition.is_axes_leaf(t):
            ref[prefix] = t
        else:
            for k in sorted(t):
                walk(t[k], f"{prefix}/{k}" if prefix else k)
    walk(ref_tf.param_axes(ref_cfg), "")
    assert port.keys() == ref.keys()
    for name, axes in port.items():
        want = ref[name][1:] if name.startswith("layers/") else ref[name]
        assert axes == want, name
    assert build_model(cfg, device="cpu").param_axes() == tf.param_axes(cfg)
    state = AdamW().state_axes(tf.param_axes(cfg))
    ref_state = RefAdamW().state_axes(ref_tf.param_axes(ref_cfg))
    assert state.step == ref_state.step == ()
    layout = Layout((2, 2), ("data", "model"))
    shape = ShapeConfig("s", "train", 32, 8)
    ref_shape = RefShape("s", "train", 32, 8)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((2, 2)))
    rules = profiles.make_rules(cfg, shape, layout)
    ref_rules = ref_profiles.make_rules(ref_cfg, ref_shape, mesh)
    for name, axes in port.items():
        spec = tuple(ref_rules.spec(*ref[name]))
        spec = spec[1:] if name.startswith("layers/") else spec
        block = partition.block_of(layout, layout.coords(3), rules, axes)
        assert block.axes == tuple(() if e is None else
                                   ((e,) if isinstance(e, str) else tuple(e))
                                   for e in spec), name
