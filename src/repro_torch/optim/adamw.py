"""AdamW from scratch (port of ``repro.optim.adamw``), with:

* fp32 moments regardless of param dtype (mixed-precision training),
* optional tier-2 offload of the moments (see ``repro_torch.core.tiering``),
* the reference's arithmetic: the global gradient norm over the leaves in
  the reference's leaf order, clipping, bias corrections ``1 - b ** step``
  on an fp32 step, ``eps`` added to ``sqrt(vhat)`` and decoupled weight
  decay on the fp32 parameter.  ``torch.optim.AdamW`` places eps and the
  bias corrections otherwise, so it is not used.

Trees are the port's (nested dicts and per-layer lists of tensors); the
update is functional: it returns new tensors and leaves its inputs as
they are.

On a rank grid whose rules shard the parameters (tensor parallelism,
FSDP) each rank updates its blocks, the moments following them
(``state_axes``); the global norm sums each leaf's squared block over
the axes that split it and counts a replicated leaf once, so every rank
clips by the same ``gnorm``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import hierarchy
from repro_torch.tree import leaf_groups, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # fp32 tree like params
    nu: Any                  # fp32 tree like params


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        device = next(t for _, ts, _ in leaf_groups(params) for t in ts).device
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def state_axes(self, param_axes) -> AdamWState:
        """Logical axes for the state tree (moments follow params)."""
        return AdamWState(step=(), mu=param_axes, nu=param_axes)

    @staticmethod
    def global_norm(grads, grid=None, blocks=None) -> torch.Tensor:
        """sqrt(sum of squares + 1e-30) in fp32, summed leaf by leaf in the
        reference's leaf order (a stacked leaf's layers in order).

        ``blocks`` (a tree like ``grads`` of ``partition.Block``, on the
        rank grid ``grid``): each leaf's squares are summed over the
        axes that split it, one all-reduce per set of axes, before the
        leaves are added in order."""
        sums = [torch.sum(torch.square(g.float()))
                for _, leaves, _ in leaf_groups(grads) for g in leaves]
        if blocks is not None:
            axes = [tuple(sorted(b.sharded_over))
                    for _, bs, _ in leaf_groups(blocks) for b in bs]
            sums = torch.stack(sums)
            for over in sorted(set(axes) - {()}):
                pick = torch.tensor([a == over for a in axes],
                                    device=sums.device)
                part = torch.where(pick, sums, 0.0)
                hierarchy.all_reduce(part, grid, over)
                sums = torch.where(pick, part, sums)
            sums = list(sums)
        total = None
        for s in sums:
            total = s if total is None else total + s
        return torch.sqrt(total + 1e-30)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, *,
               fetch: Optional[Callable] = None,
               stash: Optional[Callable] = None,
               grid=None, blocks=None
               ) -> Tuple[Any, AdamWState, torch.Tensor]:
        """Returns (new_params, new_state, grad_norm).

        The update runs leaf by leaf.  ``fetch`` brings a leaf's moment to
        the parameters' device just before its update, and ``stash`` puts
        the new moment where the state keeps it (the tier-2 offload of
        ``repro_torch.runtime.train``): then only one leaf's moments are
        on the device at a time.  Both default to leaving it in place.
        ``grid`` and ``blocks``: the parameters are this rank's blocks
        (``global_norm``)."""
        fetch = fetch or (lambda t: t)
        stash = stash or (lambda t: t)
        gnorm = self.global_norm(grads, grid, blocks)
        scale = (torch.clamp(self.grad_clip / gnorm, max=1.0)
                 if self.grad_clip is not None else None)

        step = state.step + 1
        stepf = step.float()
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                          device=stepf.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                          device=stepf.device), stepf)

        def upd(p, g, m, v):
            g = g.float()
            if scale is not None:
                g = g * scale
            m = self.b1 * fetch(m) + (1.0 - self.b1) * g
            v = self.b2 * fetch(v) + (1.0 - self.b2) * torch.square(g)
            mhat = m / c1
            vhat = v / c2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            pf = p.float()
            pf = pf - self.lr * (delta + self.weight_decay * pf)
            return pf.to(p.dtype), stash(m), stash(v)

        # a tree of indices into the (param, m, v) results, split in three
        out = []
        index = tree_map(lambda *a: out.append(upd(*a)) or len(out) - 1,
                         params, grads, state.mu, state.nu)

        def pick(k):
            return tree_map(lambda i: out[i][k], index)

        return pick(0), AdamWState(step, pick(1), pick(2)), gnorm
