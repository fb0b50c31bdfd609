"""Training-step factory (port of ``repro.runtime.train``): microbatched
gradient accumulation, remat, AdamW, optimizer-state tiering, and data
parallelism across processes with the ScalePool hierarchical cross-pod
gradient phase.

Modes, on a rank grid (``repro_torch.launch.mesh``; one process a rank):
  dp_mode="auto"         - the flat mean of the gradients over every data
                           rank: one all-reduce over (pod x data), what
                           GSPMD does in the reference.
  dp_mode="hierarchical" - reduce-scatter inside a pod, the mean across
                           pods on the shard (int8 codes with per-tensor
                           shared scales and error feedback under
                           ``compress_pod``), all-gather inside the pod
                           (``repro_torch.core.hierarchy``).  The
                           reference's pod mean inside a pod is GSPMD's;
                           the port's is the explicit reduce-scatter.

Each rank takes its rows of the global batch by the rules' ``batch``
axes (the reference's ``batch_shardings``), computes its loss and
gradients on them, reduces, and runs the same AdamW update, so every
rank ends with the same parameters.  Without a grid the step is the
one-device step; on a world of one, ``auto`` is that step too.

Tensor parallelism and FSDP (the dense family; ``repro_torch.sharding.
tp``): where the rules shard the parameters (a ``model`` axis over 1,
``embed`` on a mesh axis), the state holds this rank's blocks
(``state_from_params`` cuts them from a full tree), the loss runs under
the rules and grid, and the ranks of one data coordinate take the same
rows.  The gradients of leaves FSDP does not shard go through the
schedules above over the data axes, within the rank's model coordinate;
those of FSDP's leaves come back from the gathers' backward already
summed over ``data``: they are divided by its size and take only the
pod phase (flat or cross-pod mean, compressed or not).  Under
``compress_pod`` a compressed leaf's scale is its largest |gradient|
over every rank (pods, data and model blocks).

The step takes and returns a ``TrainState`` of fp32 masters, AdamW
state and residuals; it is functional (the inputs are not modified), and
a batch of numpy arrays or tensors is moved to the model's device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import hierarchy
from repro_torch.core.tiering import (TieringPolicy, offload_state,
                                      to_tier1, to_tier2)
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.sharding import partition, tp
from repro_torch.sharding.partition import Rules
from repro_torch.sharding.profiles import grid_refusal
from repro_torch.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    residuals: Any     # int8-compression error feedback (or empty dict)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    dp_mode: str = "auto"              # auto | hierarchical
    compress_pod: bool = False         # int8 EF on the cross-pod phase
    microbatches: int = 1
    remat: bool = True


def _value_and_grad(model: Model, params, batch, remat: bool):
    """loss and d loss / d params (a tree like params, in their dtype)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = model.loss(live, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def _accumulated_grads(model: Model, params, batch, tcfg: TrainStepConfig):
    """loss, grads averaged over the batch, with optional
    gradient-accumulation microbatching (fp32 sums, as the reference)."""
    if tcfg.microbatches <= 1:
        return _value_and_grad(model, params, batch, tcfg.remat)
    n = tcfg.microbatches
    lsum = None
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    for i in range(n):
        mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
              for k, v in batch.items()}
        loss, grads = _value_and_grad(model, params, mb, tcfg.remat)
        lsum = loss if lsum is None else lsum + loss
        gsum = tree_map(lambda a, b: a + b.float(), gsum, grads)
    inv = 1.0 / n
    return lsum * inv, tree_map(lambda g: g * inv, gsum)


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def batch_rows(mesh, rules: Optional[Rules], shape: ShapeConfig,
               microbatches: int = 1) -> Tuple[int, int]:
    """(first row, rows) of this rank's part of the global batch: the
    batch split in blocks over the rules' ``batch`` axes (every data axis
    without rules), block ``i`` to the ranks whose row-major index over
    those axes is ``i`` (the reference's ``batch_shardings``); the whole
    batch where the rules leave it unsharded."""
    axes = rules.spec("batch")[0] if rules is not None else mesh.data_axes
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    n = mesh.size(axes)
    B = shape.global_batch
    if B % (n * max(1, microbatches)):
        raise ValueError(f"batch {B} does not split over {n} ranks x "
                         f"{microbatches} microbatches")
    return mesh.index(axes) * (B // n), B // n


def _fsdp_axes(block) -> Tuple[str, ...]:
    """The axes other than ``model`` that split a leaf: FSDP's."""
    return tuple(a for a in (block.sharded_over if block else ())
                 if a != "model")


def split_fsdp(tree, blocks):
    """(the tree with FSDP's leaves emptied, the tree with only FSDP's
    leaves): an emptied leaf has no elements, so the flat buffers of
    ``core.hierarchy`` skip it."""
    if blocks is None:
        return tree, None
    def keep(fsdp):
        return lambda t, b: t if bool(_fsdp_axes(b)) == fsdp \
            else t.new_zeros((0,))
    return tree_map(keep(False), tree, blocks), tree_map(keep(True), tree,
                                                         blocks)


def _merge_fsdp(rest, sharded, blocks):
    return tree_map(lambda r, f, b: f if _fsdp_axes(b) else r, rest,
                    sharded, blocks)


def _fsdp_reduce(grid, tcfg: TrainStepConfig, grads, blocks, residual):
    """FSDP's leaves, summed over their axes by the gathers' backward:
    divided by those axes' size, then the mean over the other data axes
    (the pods), compressed under ``compress_pod``.  Returns (grads, new
    residual or None)."""
    over = next(_fsdp_axes(b) for b in tree_leaves(blocks) if _fsdp_axes(b))
    rest_axes = tuple(a for a in grid.data_axes if a not in over)
    flat_tree = hierarchy.FlatTree(grads)
    flat = flat_tree.flatten(grads).div_(grid.size(over))
    new = None
    if grid.size(rest_axes) > 1 and tcfg.compress_pod:
        if residual is not None:
            flat = flat + residual
        flat, new = hierarchy.compressed_mean(
            flat, flat_tree.segments(0, flat.numel()), grid, rest_axes[0],
            hierarchy.SCALE_AXES)
    elif grid.size(rest_axes) > 1:
        hierarchy.all_reduce(flat, grid, rest_axes).div_(
            grid.size(rest_axes))
    return flat_tree.unflatten(flat), new


def _grid_reduce(grid, tcfg: TrainStepConfig, loss, grads, residuals,
                 blocks=None):
    """(loss, grads, residuals) reduced over the data ranks by
    ``tcfg.dp_mode``: the loss is the mean over the data axes in
    ``auto``, and for ``hierarchical`` the pod's mean, then its mean
    over pods, as the reference's ``pmean``.  ``blocks``: the
    parameters' blocks when the rules shard them (FSDP's leaves take
    ``_fsdp_reduce``)."""
    grads, sharded = split_fsdp(grads, blocks)
    fsdp = sharded is not None and any(
        _fsdp_axes(b) for b in tree_leaves(blocks))
    new_res = dict(residuals)
    if fsdp:
        sharded, new = _fsdp_reduce(grid, tcfg, sharded, blocks,
                                    residuals.get("fsdp"))
        if new is not None:
            new_res["fsdp"] = new
    if tcfg.dp_mode == "auto":
        loss = hierarchy.cross_pod_mean(loss, grid, grid.data_axes)
        grads = hierarchy.reduce_gradients_flat(grads, grid)
    else:
        loss = hierarchy.cross_pod_mean(
            hierarchy.cross_pod_mean(loss, grid, "data"), grid, "pod")
        res = residuals.get("g") if tcfg.compress_pod else None
        grads, new = hierarchy.reduce_gradients_hierarchically(
            grads, grid, compress=tcfg.compress_pod, residuals=res)
        if tcfg.compress_pod:
            new_res["g"] = new
    if fsdp:
        grads = _merge_fsdp(grads, sharded, blocks)
    return loss, grads, new_res


def param_blocks(model: Model, mesh, rules: Optional[Rules]):
    """The tree of this rank's ``partition.Block`` per parameter, or None
    where the rules shard no parameter (``tp.make_plan``)."""
    if tp.make_plan(mesh, rules) is None:
        return None
    return partition.tree_shardings(mesh, rules, model.param_axes())


def make_train_step(model: Model, optimizer: AdamW, shape: ShapeConfig, *,
                    mesh=None, rules: Optional[Rules] = None,
                    tcfg: TrainStepConfig = TrainStepConfig(),
                    tiering: Optional[TieringPolicy] = None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``mesh``: this rank's ``launch.mesh.RankGrid``; the step then takes
    the global batch, computes on this rank's rows (``batch_rows``, by
    ``rules``' ``batch`` axes) and reduces by ``tcfg.dp_mode`` before the
    update.  Every rank must start from the same state, cut to its blocks
    where the rules shard the parameters (``state_from_params(...,
    mesh=..., rules=..., axes=...)``).  With ``compress_pod`` the state's
    residual is this rank's shard of its pod's error feedback
    (``state_from_params`` makes it).  The grid's ``stats`` count the
    collectives' bytes and host seconds.

    ``tiering``: with ``offload_optimizer`` (or ``offload_master_params``)
    the state keeps those components in tier 2 (``init_state`` and
    ``core.tiering.offload_state`` put them there).  The masters come to
    the card ``non_blocking`` before the forward; the moments only after
    the backward, a leaf at a time inside the AdamW update, each new one
    copied back as soon as it is made, so they never share the card with
    the activations or with each other.  The step waits for the copies,
    so the host may read the state it returns."""
    if tcfg.dp_mode not in ("auto", "hierarchical"):
        raise ValueError(f"unknown dp_mode {tcfg.dp_mode!r}")
    if tcfg.dp_mode == "hierarchical" and (
            mesh is None or "pod" not in mesh.axis_names):
        raise ValueError("hierarchical dp_mode needs a mesh with a 'pod' axis")
    if shape.global_batch % max(1, tcfg.microbatches):
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{tcfg.microbatches} microbatches")
    rows = blocks = None
    if mesh is not None:
        why = grid_refusal(mesh, rules, model.cfg)
        if why is not None:
            raise ValueError(why)
        rows = batch_rows(mesh, rules, shape, tcfg.microbatches)
        blocks = param_blocks(model, mesh, rules)
    distributed = mesh is not None and (mesh.world > 1
                                        or tcfg.dp_mode != "auto")
    moments_out = tiering is not None and tiering.offload_optimizer
    masters_out = tiering is not None and tiering.offload_master_params

    def onload(t):
        return to_tier1(t, model.device)

    def step(state: TrainState, batch) -> Tuple[TrainState,
                                                Dict[str, torch.Tensor]]:
        if rows is not None:
            batch = {k: v[rows[0]:rows[0] + rows[1]]
                     for k, v in batch.items()}
        batch = _to_device(batch, model.device)
        params = tree_map(onload, state.params) if masters_out \
            else state.params
        with partition.use_rules(rules, mesh) if blocks is not None \
                else contextlib.nullcontext():
            loss, grads = _accumulated_grads(model, params, batch, tcfg)
        residuals = state.residuals
        if distributed:
            loss, grads, residuals = _grid_reduce(mesh, tcfg, loss, grads,
                                                  residuals, blocks)
        tier = {"fetch": onload, "stash": to_tier2} if moments_out else {}
        if blocks is not None:
            tier.update(grid=mesh, blocks=blocks)
        new_params, new_opt, gnorm = optimizer.update(grads, state.opt,
                                                      params, **tier)
        if masters_out:
            new_params = tree_map(to_tier2, new_params)
        if (moments_out or masters_out) and model.device.type == "cuda":
            torch.cuda.current_stream(model.device).synchronize()
        new_state = TrainState(new_params, new_opt, residuals)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": new_opt.step.float()}
        return new_state, metrics

    return step


def init_state(model: Model, optimizer: AdamW,
               generator: Optional[torch.Generator] = None,
               tcfg: TrainStepConfig = TrainStepConfig(),
               tiering: Optional[TieringPolicy] = None,
               mesh=None, rules: Optional[Rules] = None) -> TrainState:
    """Masters drawn from ``generator`` on the model's device, zero AdamW
    state and residuals; the components ``tiering`` offloads in tier 2.
    Every rank of a grid draws the same full masters from the same seed
    and keeps its blocks of them (``rules``)."""
    params = model.init(generator)
    axes = model.param_axes() if model.param_axes is not None else None
    return state_from_params(params, optimizer, tcfg, tiering, mesh,
                             rules=rules, axes=axes)


def state_from_params(params, optimizer: AdamW,
                      tcfg: TrainStepConfig = TrainStepConfig(),
                      tiering: Optional[TieringPolicy] = None,
                      mesh=None, *, rules: Optional[Rules] = None,
                      axes=None) -> TrainState:
    """A fresh ``TrainState`` around given masters (``init_state`` with
    the parameters drawn elsewhere, e.g. from the reference's through
    ``repro_torch.bridge``).  ``params`` is the full tree; where
    ``rules`` shard it on ``mesh`` (``axes``: its logical axes,
    ``Model.param_axes()``) the state keeps this rank's blocks.  The
    residuals: with ``compress_pod`` a tree of zeros like the masters,
    as the reference's; on a grid under ``hierarchical``, where they are
    used, this rank's zero shard of its pod's flat error feedback
    (``hierarchy.residual_shape``), and FSDP's leaves' flat shard."""
    blocks = None
    if tp.make_plan(mesh, rules) is not None:
        if axes is None:
            raise ValueError("rules that shard the parameters need their "
                             "logical axes (axes=Model.param_axes())")
        blocks = partition.tree_shardings(mesh, rules, axes)
        params = tree_map(partition.shard_leaf, params, blocks)
    residuals = {}
    if tcfg.compress_pod and mesh is not None \
            and tcfg.dp_mode == "hierarchical":
        device = tree_leaves(params)[0].device
        rest, sharded = split_fsdp(params, blocks)
        residuals = {"g": torch.zeros(hierarchy.residual_shape(rest, mesh),
                                      dtype=torch.float32, device=device)}
        if sharded is not None and any(t.numel()
                                       for t in tree_leaves(sharded)):
            residuals["fsdp"] = torch.zeros(
                (hierarchy.FlatTree(sharded).numel,), dtype=torch.float32,
                device=device)
    elif tcfg.compress_pod:
        residuals = {"g": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)}
    state = TrainState(params, optimizer.init(params), residuals)
    if tiering is not None:
        state = offload_state(state, tiering)
    return state
