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
for the dense family the parameters' entries: ``model`` (tensor
parallelism) and ``embed`` (FSDP) place each leaf's block
(``partition.tree_shardings``); ``grid_refusal`` says what waits for a
later slice.
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


def grid_refusal(mesh, rules: Optional[Rules],
                 cfg: Optional[ModelConfig] = None, *,
                 serving: bool = False) -> Optional[str]:
    """Why the port cannot run ``cfg`` on ``mesh`` (anything with
    ``axis_names`` and ``shape``: a ``RankGrid``, a ``Layout``, a lease's
    ``LeaseBinding``) with ``rules``, or None.  Tensor parallelism over
    ``model`` and FSDP (``embed`` on a mesh axis) run the dense family's
    training step (``repro_torch.sharding.tp``); what waits for a later
    slice is: attention heads or kv heads that do not divide the
    ``model`` axis (the reference's context-parallel ``seq_attn``
    fallback), the moe, ssm, hybrid and encdec families under a
    ``model`` axis over 1 or FSDP, and ``serving`` under a ``model`` axis
    over 1 (``Engine.from_lease`` and ``runtime.serve.make_lease_session``
    ask, on the mesh their lease binds: one device has no such axis)."""
    sizes = axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    embed = rules.table.get("embed") if rules is not None else None
    embed = (embed,) if isinstance(embed, str) else tuple(embed or ())
    fsdp = any(sizes.get(a, 1) > 1 for a in embed)
    if serving and model_n > 1:
        return (f"serving under a model axis of {model_n} (tensor "
                f"parallelism) comes with a later slice of the port")
    if cfg is None or (model_n == 1 and not fsdp):
        return None
    what = " and ".join(
        w for w, on in ((f"tensor parallelism (a model axis of {model_n})",
                         model_n > 1), ("FSDP", fsdp)) if on)
    if cfg.family != "dense":
        later = {"moe": "expert parallelism",
                 "ssm": "the ssm_* sharding rules",
                 "hybrid": "the ssm_* sharding rules",
                 "encdec": "the encoder-decoder's sharded step"}
        return (f"{cfg.name}: the {cfg.family} family under {what} needs "
                f"{later.get(cfg.family, 'its sharded step')}, which comes "
                f"with a later slice of the port; this one shards the dense "
                f"family")
    if model_n > 1 and (cfg.n_heads % model_n or cfg.n_kv_heads % model_n):
        return (f"{cfg.name}: {cfg.n_heads} heads and {cfg.n_kv_heads} kv "
                f"heads do not both divide a model axis of {model_n}; the "
                f"reference's context-parallel seq_attn fallback for "
                f"tensor parallelism comes with a later slice of the port")
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
