"""Fixed-batch serving steps (port of ``repro.runtime.serve``): a prefill
and a one-token greedy decode step over a model's contiguous cache, the
path every family the port builds is served through (ssm, hybrid and
encdec have no paged KV, so the request-level engine does not take
them).

    prefill_step(params, batch, cache) -> (next_token_logits, cache
                                           [, enc_states])
    decode_step(params, carry)         -> (logits, new_carry)

The carry is ``{"tokens": (B, 1) long, "cache": ..., "index": int}``,
plus ``"enc_states"`` for encdec; the cache is updated in place.
``make_lease_session`` binds the two steps to a ``repro_torch.pool``
lease (its device, tiering policy and grid), for fixed-batch
deployments whose capacity the pool composes.

Across ranks (a lease's grid in a world of ranks, one process each, or
``make_session`` on a rank grid) both steps run under the decode rules
of the grid (``make_rules(..., fsdp=False)``, the reference's): a step
takes the global batch and serves the rank's block of its rows (the
rules' ``batch`` axes, every row where they leave it unsharded) on the
rank's shards of the model (``sharding.tp``: heads and kv heads over
``model``, the dense and moe families, moe's experts too; the ssm and
hybrid families' SSD heads and conv channels, the hybrid's shared
attention heads; the encdec family's encoder, decoder and
cross-attention heads), over a cache of its rows, kv heads, SSD heads
and conv channels (the family's ``init_cache`` under the plan); moe's
dispatch group stays the whole batch (``tp.split_rows``), the
reference's one group.  An encdec prefill takes the rank's rows of the
batch's ``frame_embeds`` and returns their encoder states (the
reference's ``("batch", None, "embed")``), which the carry keeps; each
decode step projects them onto the rank's kv heads for the cross K/V,
as the reference recomputes them every step.
The greedy token is ``tp.vocab_parallel_argmax`` of the rank's vocab
columns, gathered over the batch axes (``core.hierarchy``, counted in
the grid's ``CollectiveStats``): the carry's ``tokens`` are the global
(B, 1), the same bits on every rank.  A step's logits are the rank's
block (its rows, its columns); ``ServeSession.gather_logits`` puts the
global ones together.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import hierarchy
from repro_torch.core.tiering import TieringPolicy
from repro_torch.device import DeviceLike
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeConfig
from repro_torch.sharding import partition, tp
from repro_torch.sharding.profiles import grid_refusal, make_rules


def make_prefill_step(model: Model) -> Callable[..., Any]:
    """prefill_step(params, batch, cache) -> (next_token_logits, cache
    [, enc_states]): encdec's batch holds ``frame_embeds`` too."""

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(model: Model) -> Callable[..., Any]:
    """decode_step(params, carry) -> (logits, new_carry): one token for
    every row, greedy-sampled into the carry so the step is
    self-contained for a generation loop."""
    encdec = model.cfg.family == "encdec"

    def decode_step(params, carry: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        extra = (carry["enc_states"],) if encdec else ()
        logits, cache = model.decode(params, carry["tokens"], carry["cache"],
                                     carry["index"], *extra)
        new_carry = dict(carry)
        new_carry.update(tokens=torch.argmax(logits[:, -1, :], dim=-1)[:, None],
                         cache=cache, index=carry["index"] + 1)
        return logits, new_carry

    return decode_step


@dataclasses.dataclass(frozen=True)
class ServeSession:
    """The two steps of ``model`` for the decode ``shape``, and, across
    ranks, the ``plan`` they run under (the rules and rank grid; None on
    one device): what a fixed-batch serving loop needs besides the
    parameters (``load``) and a cache (``init_cache``)."""

    model: Model
    shape: ShapeConfig
    prefill_step: Callable[..., Any]
    decode_step: Callable[..., Any]
    plan: Optional[tp.Plan] = None

    @property
    def grid(self):
        """The rank grid, or None on one device."""
        return None if self.plan is None else self.plan.grid

    def rows(self, batch: int) -> Tuple[int, int]:
        """(first row, rows) of this rank's block of a global batch of
        ``batch`` rows."""
        return _rows(self.plan, batch)

    def load(self, params):
        """The parameters this rank serves from the full tree ``params``
        (as drawn): its blocks (``tp.shard_params``) under a ``model``
        axis over 1, cast to the compute dtype (``Model.load``)."""
        if self.plan is not None and self.plan.model_n > 1:
            params = tp.shard_params(params, self.model.param_axes(),
                                     self.plan)
        return self.model.load(params)

    def init_cache(self, batch: int, max_seq: int, dtype=None):
        """The cache of this rank's rows of a global ``batch`` and its kv
        heads (the family's default dtype unless ``dtype``)."""
        kw = {} if dtype is None else {"dtype": dtype}
        with _scope(self.plan):
            return self.model.init_cache(self.rows(batch)[1], max_seq, **kw)

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The global (B, 1) greedy tokens of a step's last position."""
        return _greedy(self.plan, logits[:, -1, :],
                       self.model.cfg.vocab)[:, None]

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The global logits (B, S, vocab) from every rank's block."""
        if self.plan is None:
            return logits
        grid = self.plan.grid
        if self.plan.model_n > 1:
            logits = hierarchy.all_gather_dim(logits.contiguous(), grid,
                                              tp.MODEL, logits.dim() - 1)
        logits = logits[..., :self.model.cfg.vocab]
        axes = self.plan.batch_axes
        if axes:
            logits = hierarchy.all_gather_dim(logits.contiguous(), grid,
                                              axes, 0)
        return logits


@dataclasses.dataclass(frozen=True)
class LeaseServeSession(ServeSession):
    """Everything a fixed-batch serving worker needs from its pool lease:
    the device the lease binds (``binding.device``), its mesh shape and
    tiering policy (``binding.policy``), the decode ``shape`` it serves,
    the two steps, and across ranks the ``plan`` of the lease's grid and
    decode rules (the reference's session carries its ``mesh`` and
    ``rules``).  Request-level serving builds ``Engine.from_lease``
    instead."""

    binding: Any = None                # repro_torch.pool.LeaseBinding

    @property
    def device(self) -> torch.device:
        return self.binding.device

    @property
    def policy(self) -> TieringPolicy:
        return self.binding.policy

    @property
    def kv_spill(self) -> bool:
        return self.policy.kv_spill


def _scope(plan_):
    if plan_ is None:
        return contextlib.nullcontext()
    return partition.use_rules(plan_.rules, plan_.grid)


def _rows(plan_, batch: int) -> Tuple[int, int]:
    if plan_ is None:
        return 0, batch
    n = plan_.grid.size(plan_.batch_axes)
    if batch % n:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{n} ranks of {plan_.batch_axes}")
    return plan_.rows(batch)


def _take_rows(plan_, x: torch.Tensor) -> torch.Tensor:
    start, n = _rows(plan_, x.shape[0])
    return x if n == x.shape[0] else x[start:start + n]


def _greedy(plan_, last: torch.Tensor, vocab: int) -> torch.Tensor:
    """Global (B,) greedy tokens of the rank's block of last-position
    logits: over ``model`` by ``tp.vocab_parallel_argmax``, then every
    rank's rows gathered over the batch axes."""
    if plan_ is None:
        return torch.argmax(last, dim=-1)
    tok = tp.vocab_parallel_argmax(last, vocab, plan_)
    axes = plan_.batch_axes
    if axes:
        tok = hierarchy.all_gather_dim(tok.contiguous(), plan_.grid, axes, 0)
    return tok


def make_session(model: Model, shape: ShapeConfig,
                 grid=None) -> ServeSession:
    """The steps of ``model`` on one device (``grid`` None, or a world
    of one), or across the ranks of ``grid`` (a
    ``launch.mesh.RankGrid``) under its decode rules for ``shape``
    (FSDP off, the reference's); the caller checks the grid
    (``profiles.grid_refusal(..., serving=True)``)."""
    return ServeSession(model, shape, *_steps(model, shape, grid))


def _steps(model: Model, shape: ShapeConfig, grid):
    """(prefill_step, decode_step, plan) of ``make_session``."""
    if grid is None or grid.world == 1:
        return make_prefill_step(model), make_decode_step(model), None
    plan_ = tp.Plan(grid, make_rules(model.cfg, shape, grid, fsdp=False))
    encdec = model.cfg.family == "encdec"
    vocab = model.cfg.vocab
    # the rank's rows are its block of the batch: the moe layer's
    # dispatch group stays the whole batch
    split = tp.split_of(grid, plan_.batch_axes)

    def prefill_step(params, batch, cache):
        local = {k: _take_rows(plan_, v) for k, v in batch.items()}
        with _scope(plan_), tp.split_rows(split):
            return model.prefill(params, local, cache)

    def decode_step(params, carry: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        extra = (carry["enc_states"],) if encdec else ()
        with _scope(plan_), tp.split_rows(split):
            logits, cache = model.decode(
                params, _take_rows(plan_, carry["tokens"]), carry["cache"],
                carry["index"], *extra)
            tokens = _greedy(plan_, logits[:, -1, :], vocab)
        new_carry = dict(carry)
        new_carry.update(tokens=tokens[:, None], cache=cache,
                         index=carry["index"] + 1)
        return logits, new_carry

    return prefill_step, decode_step, plan_


def make_lease_session(model: Model, shape: ShapeConfig, lease, *,
                       device: DeviceLike = None) -> LeaseServeSession:
    """Bind a ``repro_torch.pool.Lease`` to a runnable serving session.

    The lease's ``materialize`` picks the device (``device=`` names it,
    e.g. ``"cpu"``; the default is the card) and its tier-2 reservation
    the KV spill policy.  The steps are ``make_prefill_step`` /
    ``make_decode_step`` of ``model``, which must live on that device.
    In a world of ranks (one process each, ``torch.distributed.run``)
    each rank joins the lease's grid (``LeaseBinding.join``) and the
    steps run under its decode rules for ``shape`` (the reference's
    ``make_rules(..., fsdp=False)``): rows over the data axes, heads
    over ``model`` (see the module's docstring).  Refused
    (``profiles.grid_refusal``), each naming its slice: a ``model`` axis
    over 1 bound to one process (several cards), heads (attention or SSD
    heads) that do not divide it."""
    binding = lease.materialize(None if device is None else [device])
    why = grid_refusal(binding, model.cfg, serving=True)
    if why is not None:
        raise ValueError(why)
    if binding.device.type != model.device.type:
        raise ValueError(f"lease device {binding.device} differs from the "
                         f"model's {model.device}")
    grid = binding.join() if binding.world > 1 else None
    return LeaseServeSession(model, shape, *_steps(model, shape, grid),
                             binding=binding)
