"""Tensor parallelism over the grid's ``model`` axis and FSDP over its
``data`` axis, as explicit collectives (what GSPMD inserts in the
reference's sharded training step).

A model reads the ``Plan`` of the rules and rank grid in force
(``partition.use_rules(rules, grid)``; ``plan()`` is None without them
or when they shard nothing).  Each collective is a
``torch.autograd.Function`` over one of the grid's groups, staged and
counted by ``repro_torch.core.hierarchy``:

* ``copy_to_model``: identity forward, all-reduce over ``model``
  backward.  It goes before the column-parallel projections (``wq``,
  ``wk``, ``wv``, ``w_up``, ``w_gate``) and before the tied
  unembedding, whose input every rank of the group holds whole;
* ``reduce_from_model``: all-reduce over ``model`` forward, identity
  backward, after the row-parallel ``wo`` and ``w_down`` and after the
  vocab-parallel embedding lookup (a token outside the rank's rows of
  the table gives zeros, so the sum is exact);
* ``gather_cast`` (FSDP): a parameter's ``data`` shard cast to the
  compute dtype and all-gathered just before use (cast first: cast and
  gather commute, and half the bytes move); backward, the fp32
  reduce-scatter of the gradient's sum over ``data``;
* ``vocab_parallel_cross_entropy``: the loss over the rank's columns
  of the logits, its row max, sum of exponentials and gold logit
  all-reduced over ``model``, in fp32.  The table has
  ``cfg.padded_vocab`` rows; the reference slices the logits to
  ``vocab`` before its loss, so the padded columns are left out of the
  log-sum-exp here.

The collectives run in program order, the same on every rank of a
group; a remat recompute (``transformer.remat``) re-runs the forward's
in the same order during the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import hierarchy
from repro_torch.sharding import partition

MODEL = ("model",)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The rules and rank grid a model runs under."""
    grid: Any                       # launch.mesh.RankGrid
    rules: partition.Rules

    @property
    def model_n(self) -> int:
        return self.grid.size(MODEL)

    @property
    def model_index(self) -> int:
        return self.grid.index(MODEL)

    def block(self, logical_axes) -> partition.Block:
        return partition.logical_to_sharding(self.grid, self.rules,
                                             logical_axes)

    @property
    def fsdp(self) -> bool:
        """Whether parameters are sharded on ``embed`` (over an axis of
        more than one rank)."""
        return not self.block(("embed",)).whole

    def local_attention(self, acfg):
        """``acfg`` with this rank's heads: ``n_heads / model`` and
        ``n_kv_heads / model``."""
        return dataclasses.replace(acfg, n_heads=acfg.n_heads // self.model_n,
                                   n_kv_heads=acfg.n_kv_heads // self.model_n)


def make_plan(grid, rules: Optional[partition.Rules]) -> Optional[Plan]:
    """The plan of ``rules`` on ``grid``, or None where they shard no
    parameter (a ``model`` axis of 1, ``embed`` on no axis over 1)."""
    if grid is None or rules is None or not hasattr(grid, "layout"):
        return None
    p = Plan(grid, rules)
    return p if (p.model_n > 1 or p.fsdp) else None


def plan() -> Optional[Plan]:
    """The plan in force (``partition.use_rules``), or None."""
    return make_plan(partition.current_mesh(), partition.current_rules())


# ---------------------------------------------------------------------------
# the collectives as autograd Functions
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return hierarchy.all_reduce(g.contiguous().clone(), ctx.grid,
                                    MODEL), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        return hierarchy.all_reduce(x.contiguous().clone(), grid, MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dtype, grid, block):
        ctx.grid, ctx.block, ctx.dtype = grid, block, shard.dtype
        out = shard.to(dtype)
        for dim, axes in enumerate(block.axes):
            if axes and axes != MODEL:
                out = hierarchy.all_gather_dim(out, grid, axes, dim)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.float()
        for dim, axes in reversed(list(enumerate(ctx.block.axes))):
            if axes and axes != MODEL:
                g = hierarchy.reduce_scatter_dim(g, ctx.grid, axes, dim)
        return g.to(ctx.dtype), None, None, None


def copy_to_model(x: torch.Tensor, plan_: Optional[Plan]) -> torch.Tensor:
    if plan_ is None or plan_.model_n == 1:
        return x
    return _CopyToModel.apply(x, plan_.grid)


def reduce_from_model(x: torch.Tensor, plan_: Optional[Plan]) -> torch.Tensor:
    if plan_ is None or plan_.model_n == 1:
        return x
    return _ReduceFromModel.apply(x, plan_.grid)


def _data_sharded(block: partition.Block) -> bool:
    return any(axes and axes != MODEL for axes in block.axes)


def gather_cast(shard: torch.Tensor, logical_axes, plan_: Plan,
                dtype) -> torch.Tensor:
    """A parameter as its rank uses it: its ``data`` shard (FSDP) cast to
    ``dtype`` and gathered, its ``model`` block kept; a leaf FSDP does
    not shard is only cast."""
    block = plan_.block(logical_axes)
    if not _data_sharded(block):
        return shard.to(dtype)
    return _GatherCast.apply(shard, dtype, plan_.grid, block)


def cast_params(params, axes_tree, plan_: Plan, dtype):
    """``transformer.cast_params`` under a plan: every leaf to ``dtype``
    but the FSDP-sharded ones, which stay fp32 shards until
    ``gather_params`` casts and gathers them where they are used."""
    def cast(axes, t):
        if _data_sharded(plan_.block(axes)) or not t.is_floating_point():
            return t
        return t.to(dtype)
    return partition.map_axes(cast, axes_tree, params)


def gather_params(params, axes_tree, plan_: Plan, dtype):
    """A subtree's leaves as the rank uses them (``gather_cast``), and a
    ``head_dim`` scale (qk-norm) behind ``copy_to_model``: it is read on
    the rank's local heads, so its gradient is summed over ``model``."""
    def use(axes, t):
        t = gather_cast(t, axes, plan_, dtype) if t.is_floating_point() \
            else t
        return copy_to_model(t, plan_) if axes == ("head_dim",) else t
    return partition.map_axes(use, axes_tree, params)


# ---------------------------------------------------------------------------
# the vocab-parallel embedding and cross entropy
# ---------------------------------------------------------------------------

def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                plan_: Plan) -> torch.Tensor:
    """Rows of the table whose vocab rows are split over ``model``: each
    rank looks up the tokens in its rows (zeros for the others'), and
    the sum over the group is the lookup."""
    if plan_.model_n == 1:
        return F.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens.long() - plan_.model_index * rows
    inside = (local >= 0) & (local < rows)
    out = F.embedding(torch.where(inside, local, 0), table)
    out = out.masked_fill(~inside[..., None], 0)
    return reduce_from_model(out, plan_)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask, start, vocab, grid):
        V = logits.shape[-1]
        lf = logits.float()
        pad = torch.arange(start, start + V, device=lf.device) >= vocab
        if bool(pad.any()):
            lf = lf.masked_fill(pad, float("-inf"))
        top = lf.amax(dim=-1)
        hierarchy.all_reduce(top, grid, MODEL, op="max")
        sumexp = torch.exp(lf - top[..., None]).sum(dim=-1)
        hierarchy.all_reduce(sumexp, grid, MODEL)
        local = labels.long() - start
        inside = (local >= 0) & (local < V)
        safe = torch.where(inside, local, 0)
        gold = torch.gather(lf, -1, safe[..., None])[..., 0]
        gold = torch.where(inside, gold, 0.0)
        hierarchy.all_reduce(gold, grid, MODEL)
        nll = torch.log(sumexp) + top - gold
        if mask is not None:
            w = mask.float()
            denom = torch.clamp(w.sum(), min=1.0)
            loss = (nll * w).sum() / denom
        else:
            w, denom = None, float(nll.numel())
            loss = nll.mean()
        ctx.save_for_backward(logits, top, sumexp, safe, inside, pad)
        ctx.w, ctx.denom = w, denom
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, top, sumexp, safe, inside, pad = ctx.saved_tensors
        lf = logits.float()
        if bool(pad.any()):
            lf = lf.masked_fill(pad, float("-inf"))
        p = torch.exp(lf - top[..., None]) / sumexp[..., None]
        p.scatter_add_(-1, safe[..., None], -inside[..., None].float())
        scale = g / ctx.denom
        if ctx.w is not None:
            p = p * (ctx.w * scale)[..., None]
        else:
            p = p * scale
        return p.to(logits.dtype), None, None, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: Optional[torch.Tensor], vocab: int,
                                 plan_: Plan) -> torch.Tensor:
    """Mean next-token cross entropy of ``labels`` over logits whose
    columns (the padded vocab's) are split over ``model``: ``logits``
    (B, S, V_pad / model) are this rank's; every rank of the group gets
    the loss, and the gradient of its own columns."""
    start = plan_.model_index * logits.shape[-1]
    return _VocabParallelCE.apply(logits, labels, mask, start, vocab,
                                  plan_.grid)
