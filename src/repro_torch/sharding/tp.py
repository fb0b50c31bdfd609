"""Tensor parallelism over the grid's ``model`` axis and FSDP over its
``data`` axis, as explicit collectives (what GSPMD inserts in the
reference's sharded training step and in its engine's programs on a
lease's mesh).

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
* ``gather_model``: tensors whose blocks are split over ``model``
  (the mamba2 block's ``in_proj`` output and conv weights, in
  contiguous blocks that are not head-aligned) all-gathered in one
  collective; backward, the reduce-scatter of their gradients' sum
  over ``model``, in fp32 (a rank's gradient of the whole is nonzero
  only where it used it: its heads' columns and the shared B and C);
* ``sum_over_model``: an all-reduce over ``model`` whose backward is an
  all-reduce too: the sum (the gated RMSNorm's sum of squares over the
  whole ``d_inner``) feeds only the rank's own elements, so each
  rank's gradient of it is partial;
* ``vocab_parallel_cross_entropy``: the loss over the rank's columns
  of the logits, its row max, sum of exponentials and gold logit
  all-reduced over ``model``, in fp32.  The table has
  ``cfg.padded_vocab`` rows; the reference slices the logits to
  ``vocab`` before its loss, so the padded columns are left out of the
  log-sum-exp here;
* ``vocab_parallel_argmax``: the serving engine's greedy token over the
  rank's columns of the logits: each rank's best value and its global
  index, gathered over ``model``, the largest value winning and the
  lowest index among equals (``torch.argmax``'s rule on the whole row),
  the padded columns never.

A model call whose rows are one rank's block of a batch split over the
grid's batch axes says so (``split_rows``, a ``RowSplit``): the moe
layer's dispatch group is then the whole batch, as the reference's one
group (``moe_groups=1``) under GSPMD is.  The caller states it (the
training step, the fixed-batch session, the engine's decode); a plan
alone does not tell whether the rows it is given are split.  Two
collectives over the batch axes serve that group:

* ``gather_experts``: each rank's entries' experts (its tokens' top-k
  choices), all-gathered: every rank then holds the batch's dispatch
  list and so every entry's place in it, its own and a shadow row's
  (``RowSplit.shadow``);
* ``sum_over_rows``: the all-reduce of the rank's sum of router
  probabilities (the load-balancing loss's mean); backward, the
  gradient times the group's size: every rank's loss holds the same
  aux term, whose gradient the data-parallel mean then divides by it.

The collectives run in program order, the same on every rank of a
group; a remat recompute (``transformer.remat``) re-runs the forward's
in the same order during the backward.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator, Optional, Tuple

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

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The grid axes over 1 that split a batch's rows under the
        rules' ``batch`` (none where they leave it unsharded)."""
        axes = self.rules.spec("batch")[0]
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return tuple(a for a in axes if self.grid.size((a,)) > 1)

    def rows(self, batch: int) -> Tuple[int, int]:
        """(first row, rows) of this rank's block of ``batch`` rows over
        the n ranks of ``batch_axes``: blocks of ceil(batch / n) rows in
        the ranks' order, the last ones short (or empty) where n does
        not divide ``batch``; every row without batch axes."""
        axes = self.batch_axes
        n = self.grid.size(axes)
        per = -(-batch // n)
        start = min(self.grid.index(axes) * per, batch)
        return start, min(per, batch - start)

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


def shard_params(params, axes_tree, plan_: Plan):
    """This rank's blocks (``partition.shard_leaf``) of the full tree
    ``params`` whose logical axes are ``axes_tree``."""
    return partition.map_axes(
        lambda axes, t: partition.shard_leaf(t, plan_.block(axes)),
        axes_tree, params)


# ---------------------------------------------------------------------------
# the collectives as autograd Functions
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, what):
        ctx.grid, ctx.what = grid, what
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return hierarchy.all_reduce(g.contiguous().clone(), ctx.grid,
                                    MODEL, what=ctx.what), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, what):
        return hierarchy.all_reduce(x.contiguous().clone(), grid, MODEL,
                                    what=what)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


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


def copy_to_model(x: torch.Tensor, plan_: Optional[Plan],
                  what: str = "") -> torch.Tensor:
    """``what``: the name its backward's all-reduce is counted under
    (``hierarchy``), if any."""
    if plan_ is None or plan_.model_n == 1:
        return x
    return _CopyToModel.apply(x, plan_.grid, what)


def reduce_from_model(x: torch.Tensor, plan_: Optional[Plan],
                      what: str = "") -> torch.Tensor:
    if plan_ is None or plan_.model_n == 1:
        return x
    return _ReduceFromModel.apply(x, plan_.grid, what)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, dims, what, *parts):
        ctx.grid, ctx.dims, ctx.what = grid, dims, what
        fronts = [t.movedim(d, 0).contiguous() for t, d in zip(parts, dims)]
        ctx.shapes = [f.shape for f in fronts]
        ctx.dtypes = [t.dtype for t in parts]
        n = grid.size(MODEL)
        every = hierarchy.all_gather(
            torch.cat([f.reshape(-1) for f in fronts]), grid, MODEL,
            what).view(n, -1)
        out, at = [], 0
        for f, d in zip(fronts, dims):
            k = f.numel()
            out.append(every[:, at:at + k].reshape(
                (n * f.shape[0],) + f.shape[1:]).movedim(0, d))
            at += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.grid.size(MODEL)
        flat = torch.cat([g.float().movedim(d, 0).reshape(n, -1)
                          for g, d in zip(grads, ctx.dims)], 1)
        mine = hierarchy.reduce_scatter(flat.reshape(-1), ctx.grid, MODEL,
                                        ctx.what)
        out, at = [], 0
        for shape, d, dtype in zip(ctx.shapes, ctx.dims, ctx.dtypes):
            k = shape.numel()
            out.append(mine[at:at + k].reshape(shape).movedim(0, d)
                       .to(dtype))
            at += k
        return (None, None, None, *out)


def gather_model(parts, dims, plan_: Plan, what: str = ""):
    """Each tensor of ``parts``, this rank's block along its dimension of
    ``dims`` of a tensor split in contiguous blocks over ``model``, made
    whole: one all-gather for all of them (counted under ``what``);
    backward, one reduce-scatter of their gradients' sum, in fp32."""
    return _GatherModel.apply(plan_.grid, tuple(dims), what, *parts)


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid, what):
        ctx.grid, ctx.what = grid, what
        return hierarchy.all_reduce(x.contiguous().clone(), grid, MODEL,
                                    what=what)

    @staticmethod
    def backward(ctx, g):
        return hierarchy.all_reduce(g.contiguous().clone(), ctx.grid, MODEL,
                                    what=ctx.what), None, None


def sum_over_model(x: torch.Tensor, plan_: Plan,
                   what: str = "") -> torch.Tensor:
    """The sum of ``x`` over ``model`` where every rank uses it only on
    its own elements: its gradient, each rank's partial one, is summed
    over ``model`` too."""
    return _SumOverModel.apply(x, plan_.grid, what)


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
# rows split over the batch axes: the moe layer's whole-batch group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowSplit:
    """A model call's rows as this rank's block of a batch split over
    ``axes`` of ``grid`` (each over 1), the blocks in the ranks' order
    end to end (``Plan.rows``).  ``rows``: the batch's rows, every
    block's together (None: the group's size times this call's, the
    blocks all alike); ``real``: how many of this block's rows are the
    batch's, the rest padding it to the others' size (None: all);
    ``shadow``: the batch row a call appends after its block (and its
    padding), computed as its owner computes it, counted nowhere (the
    engine's idle rows read its K/V, ``serve.engine``), or None."""
    grid: Any                       # launch.mesh.RankGrid
    axes: Tuple[str, ...]
    rows: Optional[int] = None
    real: Optional[int] = None
    shadow: Optional[int] = None

    @property
    def n(self) -> int:
        return self.grid.size(self.axes)

    @property
    def index(self) -> int:
        return self.grid.index(self.axes)

    def total(self, local_rows: int) -> int:
        """The batch's rows, for a call of ``local_rows``."""
        return self.n * local_rows if self.rows is None else self.rows


_SPLIT = contextvars.ContextVar("repro_torch_row_split", default=None)


def split_of(grid, axes, rows: Optional[int] = None,
             real: Optional[int] = None,
             shadow: Optional[int] = None) -> Optional[RowSplit]:
    """The ``RowSplit`` of rows over ``axes`` of ``grid``, or None where
    no grid or no axis over 1 splits them."""
    if grid is None:
        return None
    axes = tuple(a for a in axes if grid.size((a,)) > 1)
    return RowSplit(grid, axes, rows, real, shadow) if axes else None


@contextlib.contextmanager
def split_rows(split: Optional[RowSplit]) -> Iterator[None]:
    """Model calls inside run on this rank's block of rows (``split``),
    or on the whole batch (None)."""
    token = _SPLIT.set(split)
    try:
        yield
    finally:
        _SPLIT.reset(token)


def row_split() -> Optional[RowSplit]:
    """The ``RowSplit`` in force (``split_rows``), or None."""
    return _SPLIT.get()


def gather_experts(entries: torch.Tensor, split: RowSplit) -> torch.Tensor:
    """The batch's dispatch list: every rank's 1-D ``entries`` (its
    block's token-expert entries, an expert id each, int32), end to end
    in the ranks' order."""
    return hierarchy.all_gather(entries.contiguous(), split.grid,
                                split.axes, what="moe-experts")


class _SumOverRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.n = split.n
        return hierarchy.all_reduce(x.contiguous().clone(), split.grid,
                                    split.axes, what="moe-aux")

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


def sum_over_rows(x: torch.Tensor, split: RowSplit) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``split``'s group.  Every rank
    of the group computes the same loss term from it, so the sum's
    gradient, the group's gradients summed, is n times the rank's own;
    the data-parallel mean of the step then counts the term once."""
    return _SumOverRows.apply(x, split)


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


def vocab_parallel_argmax(local_logits: torch.Tensor, vocab: int,
                          plan_: Optional[Plan]) -> torch.Tensor:
    """The greedy token of each row of logits whose columns (the padded
    vocab's, in rank order) are split over ``model``: ``local_logits``
    (..., V_pad / model) are this rank's.  Columns at or beyond
    ``vocab`` (the table's random padding) never win.  Each rank takes
    its best column (the first of equals) and its global index; one
    all-gather over ``model`` brings every rank's pair, in float64,
    which holds any fp32 or bf16 logit and any index exactly; the
    largest value wins, and among equals the lowest rank, whose columns
    come first: ``torch.argmax`` over the whole row.  Every rank returns
    the same int64 tensor (...,).  Without a plan, or with a ``model``
    axis of 1, it is ``torch.argmax`` of the first ``vocab`` columns."""
    if plan_ is None or plan_.model_n == 1:
        return torch.argmax(local_logits[..., :vocab], dim=-1)
    V = local_logits.shape[-1]
    start = plan_.model_index * V
    lf = local_logits
    if start + V > vocab:
        lf = lf[..., :max(vocab - start, 0)]
    if lf.shape[-1]:
        index = torch.argmax(lf, dim=-1)
        value = torch.gather(lf, -1, index[..., None])[..., 0]
        pair = torch.stack([value.double(), (index + start).double()], -1)
    else:                       # a rank holding only padded columns
        pair = torch.full(local_logits.shape[:-1] + (2,), float("-inf"),
                          dtype=torch.float64, device=local_logits.device)
    every = hierarchy.all_gather_dim(pair[None], plan_.grid, MODEL, 0)
    best = torch.argmax(every[..., 0], dim=0)
    return torch.gather(every[..., 1], 0, best[None])[0].long()
