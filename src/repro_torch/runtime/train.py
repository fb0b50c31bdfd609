"""Training-step factory (port of ``repro.runtime.train``): microbatched
gradient accumulation, remat, AdamW, and optimizer-state tiering.

The port trains on one device, so only ``dp_mode="auto"`` exists: the
reference's one GSPMD program over a mesh is, on one card, the plain
step.  ``"hierarchical"`` (the pod axis reduced explicitly across pods)
needs several processes and comes with the ``torch.distributed`` slice;
the reference's CLI itself falls back to ``auto`` on a mesh without a
``pod`` axis.  ``compress_pod`` keeps its error-feedback residuals tree,
which only the hierarchical phase would update.

The step takes and returns a ``TrainState`` of fp32 masters, AdamW
state and residuals; it is functional (the inputs are not modified), and
a batch of numpy arrays or tensors is moved to the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.tiering import (TieringPolicy, offload_state,
                                      to_tier1, to_tier2)
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    residuals: Any     # int8-compression error feedback (or empty dict)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    dp_mode: str = "auto"              # auto (hierarchical: a later slice)
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


def make_train_step(model: Model, optimizer: AdamW, shape: ShapeConfig, *,
                    tcfg: TrainStepConfig = TrainStepConfig(),
                    tiering: Optional[TieringPolicy] = None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``tiering``: with ``offload_optimizer`` (or ``offload_master_params``)
    the state keeps those components in tier 2 (``init_state`` and
    ``core.tiering.offload_state`` put them there).  The masters come to
    the card ``non_blocking`` before the forward; the moments only after
    the backward, a leaf at a time inside the AdamW update, each new one
    copied back as soon as it is made, so they never share the card with
    the activations or with each other.  The step waits for the copies,
    so the host may read the state it returns."""
    if tcfg.dp_mode != "auto":
        raise NotImplementedError(
            f"dp_mode={tcfg.dp_mode!r} reduces across processes: it comes "
            f"with the port's multi-card slice on torch.distributed; one "
            f"device trains with dp_mode='auto'")
    if shape.global_batch % max(1, tcfg.microbatches):
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{tcfg.microbatches} microbatches")
    moments_out = tiering is not None and tiering.offload_optimizer
    masters_out = tiering is not None and tiering.offload_master_params

    def onload(t):
        return to_tier1(t, model.device)

    def step(state: TrainState, batch) -> Tuple[TrainState,
                                                Dict[str, torch.Tensor]]:
        batch = _to_device(batch, model.device)
        params = tree_map(onload, state.params) if masters_out \
            else state.params
        loss, grads = _accumulated_grads(model, params, batch, tcfg)
        tier = {"fetch": onload, "stash": to_tier2} if moments_out else {}
        new_params, new_opt, gnorm = optimizer.update(grads, state.opt,
                                                      params, **tier)
        if masters_out:
            new_params = tree_map(to_tier2, new_params)
        if (moments_out or masters_out) and model.device.type == "cuda":
            torch.cuda.current_stream(model.device).synchronize()
        new_state = TrainState(new_params, new_opt, state.residuals)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": new_opt.step.float()}
        return new_state, metrics

    return step


def init_state(model: Model, optimizer: AdamW,
               generator: Optional[torch.Generator] = None,
               tcfg: TrainStepConfig = TrainStepConfig(),
               tiering: Optional[TieringPolicy] = None) -> TrainState:
    """Masters drawn from ``generator`` on the model's device, zero AdamW
    state and residuals; the components ``tiering`` offloads in tier 2."""
    params = model.init(generator)
    return state_from_params(params, optimizer, tcfg, tiering)


def state_from_params(params, optimizer: AdamW,
                      tcfg: TrainStepConfig = TrainStepConfig(),
                      tiering: Optional[TieringPolicy] = None) -> TrainState:
    """A fresh ``TrainState`` around given masters (``init_state`` with
    the parameters drawn elsewhere, e.g. from the reference's through
    ``repro_torch.bridge``)."""
    residuals = {}
    if tcfg.compress_pod:
        residuals = {"g": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)}
    state = TrainState(params, optimizer.init(params), residuals)
    if tiering is not None:
        state = offload_state(state, tiering)
    return state
