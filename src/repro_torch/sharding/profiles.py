"""Per-(architecture x shape) sharding profiles (port of
``repro.sharding.profiles``).

Derives the logical-axis -> mesh-axis rule table from the model config
and the mesh, honoring divisibility (the reference avoids GSPMD's
padding of non-divisible shardings structurally):

* attention: head-sharded over ``model`` when heads divide the axis,
  otherwise context-parallel (q sharded on sequence, K/V gathered);
* MLP: Megatron column->row on d_ff over ``model``;
* MoE: expert-parallel over ``model`` when n_experts divides it,
  else per-expert d_ff tensor parallel;
* parameters: FSDP over the ``data`` axis on the ``embed`` dim;
* decode: KV cache head-sharded when divisible, else sequence-sharded;
* ``long_500k`` (batch=1): batch unsharded, cache sequence spread over
  all axes.

The table is the reference's, entry for entry, from the same inputs.
``make_rules`` reads only the mesh's ``axis_names`` and ``shape`` (a
tuple of sizes): the port's ``launch.mesh.Layout`` and ``RankGrid``
serve it.  The training step reads ``batch`` for each rank's rows, and
for every family the parameters' entries:
``model`` (tensor and expert parallelism: ``expert`` or ``expert_ff``;
the mamba2 block's ``ssm_inner_proj``, ``ssm_conv_ch``, ``ssm_heads``
and ``ssm_inner``) and ``embed`` (FSDP) place each leaf's block
(``partition.tree_shardings``);
serving across ranks reads the decode table's (``kv_heads`` over
``model``, FSDP off, and the rows of a fixed-batch step or of an
engine's decode bucket by ``batch`` over the data axes); ``moe_groups``
has no reader: the port's dispatch group is the whole batch, the
reference's one group (``tp.split_rows``); ``grid_refusal`` says what
waits for a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.sharding.partition import Rules


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh-like object."""
    return dict(zip(mesh.axis_names, mesh.shape))


def hierarchical_unsafe(cfg: ModelConfig) -> Optional[str]:
    """Why hierarchical data parallelism cannot run ``cfg``, or None.

    The reference refuses parametric-norm archs under jax 0.4.x, whose
    XLA partitioner hard-crashes on the partially-manual ``pod``
    shard_map.  The port compiles no XLA program: its hierarchical
    phase is explicit ``torch.distributed`` collectives, so nothing is
    unsafe and this returns None.  The function stays so the CLI asks
    the same question at the same place as the reference's."""
    del cfg
    return None


def grid_refusal(mesh, cfg: Optional[ModelConfig] = None, *,
                 serving: bool = False,
                 world: Optional[int] = None) -> Optional[str]:
    """Why the port cannot run ``cfg`` on ``mesh`` (anything with
    ``axis_names`` and ``shape``: a ``RankGrid``, a ``Layout``, a lease's
    ``LeaseBinding``) under the rules ``make_rules`` gives it, or None.
    ``world``: the ranks the run has, one process each (default
    ``mesh.world``, else 1).

    Tensor parallelism over ``model`` and FSDP (``embed`` on a mesh
    axis) run every family's training step (moe: expert parallelism,
    its experts or their ``expert_ff`` columns over ``model``; ssm and
    hybrid: the mamba2 block's SSD heads over ``model``; encdec: the
    encoder's and decoder's heads, its cross-attention's too).  Serving
    across ranks (``serving``, one rank a process,
    ``repro_torch.sharding.tp``) runs the dense and moe families on
    (pod, data, model) on every path: the fixed-batch session, the
    request-level engine, tenants of one arbiter and engines on a shared
    transport (a disaggregated cluster's tiers, co-resident engines)
    take their rows over the data axes (the rules' ``batch``; moe's
    dispatch group stays the whole batch) and their heads over
    ``model``; the ssm, hybrid and encdec families, which have no paged
    KV, through the fixed-batch session, likewise.  What waits for a
    later slice, the refusal naming its ROADMAP item: heads that do not
    divide ``model`` (3g): attention heads or kv heads (the reference's
    context-parallel ``seq_attn`` fallback) or the mamba2 block's SSD
    heads, which ``make_rules`` then leaves unsharded.  A grid of
    other than ``world`` ranks under a ``model`` axis over 1 or in a
    world of ranks (a lease binding several cards to one process, a
    world that does not fill the grid) is refused: a lease never serves
    on one card alone."""
    sizes = axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    n = _prod(sizes.values())
    world = getattr(mesh, "world", 1) if world is None else world
    rows = {a: k for a, k in sizes.items() if a != "model" and k > 1}
    if serving and (model_n > 1 or world > 1) and world != n:
        where = (f"under a model axis of {model_n}" if not rows
                 else f"on {sizes}")
        return (f"serving {where} needs a world of {n} ranks, one "
                f"process each (torch.distributed.run), not {world}: "
                f"a lease never serves on one card alone")
    if cfg is None or model_n == 1:
        return None
    if cfg.family in ("ssm", "hybrid") and (
            cfg.ssm_heads % model_n
            or (2 * cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
                + cfg.ssm_heads) % model_n):
        return (f"{cfg.name}: {cfg.ssm_heads} SSD heads (and in_proj's "
                f"columns) do not divide a model axis of {model_n}, where "
                f"the reference's rules leave ssm_heads unsharded; that "
                f"fallback comes with a later slice of the port (ROADMAP "
                f"Queue A 3g)")
    if cfg.n_heads % model_n or cfg.n_kv_heads % model_n:
        return (f"{cfg.name}: {cfg.n_heads} heads and {cfg.n_kv_heads} kv "
                f"heads do not both divide a model axis of {model_n}; the "
                f"reference's context-parallel seq_attn fallback for "
                f"tensor parallelism comes with a later slice of the port "
                f"(ROADMAP Queue A 3g)")
    return None


def make_rules(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               fsdp: bool = True, dp_mode: str = "auto") -> Rules:
    ax = axis_sizes(mesh)
    model_n = ax.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in ax)
    n_data = _prod(ax[a] for a in data_axes)

    B = shape.global_batch
    if shape.kind == "train" and shape.microbatches > 1:
        B = B // shape.microbatches

    # ---- batch placement ----
    if B % n_data == 0:
        batch_axes: Optional[Tuple[str, ...]] = data_axes
    elif "data" in ax and B % ax["data"] == 0:
        batch_axes = ("data",)
    else:
        batch_axes = None  # e.g. long_500k batch=1

    heads_div = cfg.n_heads > 0 and cfg.n_heads % model_n == 0
    kv_div = cfg.n_kv_heads > 0 and cfg.n_kv_heads % model_n == 0

    t: Dict[str, object] = {
        "batch": batch_axes,
        "layers": None,
        "seq_q": None,
        "embed": "data" if (fsdp and "data" in ax) else None,
        "embed_norm": None,
        "vocab": "model",
        "ff": "model",
        "qkv_out": "model",
        "kv_out": "model" if kv_div else None,
        "head_dim": None,
        "heads": "model" if heads_div else None,
        "kv_heads": "model" if kv_div else None,
        # context-parallel fallback when heads don't divide the axis
        "seq_attn": None if heads_div else "model",
        "seq_kv": None,
        # MoE
        "moe_groups": batch_axes,
        "expert_router": None,
        "expert": ("model" if (cfg.n_experts and cfg.n_experts % model_n == 0)
                   else None),
        "expert_ff": ("model" if not (cfg.n_experts and cfg.n_experts % model_n == 0)
                      else None),
        # SSM
        "ssm_inner_proj": "model",
        "ssm_conv_ch": "model",
        "ssm_heads": ("model" if (cfg.family in ("ssm", "hybrid")
                                  and cfg.ssm_heads % model_n == 0) else None),
        "ssm_inner": "model",
        "ssm_inner_norm": None,
    }

    if dp_mode == "hierarchical" and "pod" in ax:
        reason = hierarchical_unsafe(cfg)
        if reason:
            raise ValueError(f"refusing hierarchical sharding rules: {reason}")

    if shape.kind == "decode":
        # one-token queries: context parallelism is meaningless; spread the
        # KV cache instead.
        t["seq_attn"] = None
        if not kv_div:
            t["seq_kv"] = "model"
        if batch_axes is None:
            # long_500k: single sequence - put the cache sequence (and ssm
            # heads) across everything available.
            t["seq_kv"] = (("data", "model") if kv_div
                           else tuple(a for a in ("data", "model") if a in ax))
            if kv_div:
                t["kv_heads"] = None  # seq takes both axes
    return Rules(t)


def describe(rules: Rules) -> str:
    return ", ".join(f"{k}={v}" for k, v in sorted(rules.table.items())
                     if v is not None)
