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
one-device step; on a world of one, ``auto`` is that step too.  The
``model`` axis (tensor parallelism) and FSDP's sharded parameters wait
for the next slice and are refused.

The step takes and returns a ``TrainState`` of fp32 masters, AdamW
state and residuals; it is functional (the inputs are not modified), and
a batch of numpy arrays or tensors is moved to the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import hierarchy
from repro_torch.core.tiering import (TieringPolicy, offload_state,
                                      to_tier1, to_tier2)
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.adamw import AdamW, AdamWState
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


def _grid_reduce(grid, tcfg: TrainStepConfig, loss, grads, residuals):
    """(loss, grads, residuals) reduced over the data ranks by
    ``tcfg.dp_mode``: the loss is the mean over the world in ``auto``,
    and for ``hierarchical`` the pod's mean, then its mean over pods, as
    the reference's ``pmean``."""
    if tcfg.dp_mode == "auto":
        return (hierarchy.cross_pod_mean(loss, grid, grid.data_axes),
                hierarchy.reduce_gradients_flat(grads, grid), residuals)
    loss = hierarchy.cross_pod_mean(
        hierarchy.cross_pod_mean(loss, grid, "data"), grid, "pod")
    res = residuals.get("g") if tcfg.compress_pod else None
    grads, new = hierarchy.reduce_gradients_hierarchically(
        grads, grid, compress=tcfg.compress_pod, residuals=res)
    return loss, grads, ({"g": new} if tcfg.compress_pod else residuals)


def make_train_step(model: Model, optimizer: AdamW, shape: ShapeConfig, *,
                    mesh=None, rules: Optional[Rules] = None,
                    tcfg: TrainStepConfig = TrainStepConfig(),
                    tiering: Optional[TieringPolicy] = None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``mesh``: this rank's ``launch.mesh.RankGrid``; the step then takes
    the global batch, computes on this rank's rows (``batch_rows``, by
    ``rules``' ``batch`` axes) and reduces by ``tcfg.dp_mode`` before the
    update.  Every rank must start from the same state.  With
    ``compress_pod`` the state's residual is this rank's shard of its
    pod's error feedback (``state_from_params(..., mesh=...)`` makes it).
    The grid's ``stats`` count the collectives' bytes and host seconds.

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
    rows = None
    if mesh is not None:
        why = grid_refusal(mesh, rules)
        if why is not None:
            raise ValueError(why)
        rows = batch_rows(mesh, rules, shape, tcfg.microbatches)
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
        loss, grads = _accumulated_grads(model, params, batch, tcfg)
        residuals = state.residuals
        if distributed:
            loss, grads, residuals = _grid_reduce(mesh, tcfg, loss, grads,
                                                  residuals)
        tier = {"fetch": onload, "stash": to_tier2} if moments_out else {}
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
               mesh=None) -> TrainState:
    """Masters drawn from ``generator`` on the model's device, zero AdamW
    state and residuals; the components ``tiering`` offloads in tier 2.
    Every rank of a grid draws the same masters from the same seed."""
    params = model.init(generator)
    return state_from_params(params, optimizer, tcfg, tiering, mesh)


def state_from_params(params, optimizer: AdamW,
                      tcfg: TrainStepConfig = TrainStepConfig(),
                      tiering: Optional[TieringPolicy] = None,
                      mesh=None) -> TrainState:
    """A fresh ``TrainState`` around given masters (``init_state`` with
    the parameters drawn elsewhere, e.g. from the reference's through
    ``repro_torch.bridge``).  The residuals: with ``compress_pod`` a tree
    of zeros like the masters, as the reference's; on a grid under
    ``hierarchical``, where they are used, this rank's zero shard of its
    pod's flat error feedback (``hierarchy.residual_shape``)."""
    residuals = {}
    if tcfg.compress_pod and mesh is not None \
            and tcfg.dp_mode == "hierarchical":
        device = tree_leaves(params)[0].device
        residuals = {"g": torch.zeros(hierarchy.residual_shape(params, mesh),
                                      dtype=torch.float32, device=device)}
    elif tcfg.compress_pod:
        residuals = {"g": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)}
    state = TrainState(params, optimizer.init(params), residuals)
    if tiering is not None:
        state = offload_state(state, tiering)
    return state
