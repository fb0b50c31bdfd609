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
lease (its device and tiering policy), for fixed-batch deployments whose
capacity the pool composes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.tiering import TieringPolicy
from repro_torch.device import DeviceLike
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeConfig
from repro_torch.sharding.profiles import grid_refusal


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
class LeaseServeSession:
    """Everything a fixed-batch serving worker needs from its pool lease:
    the device the lease binds (``binding.device``), its mesh shape and
    tiering policy (``binding.policy``), the decode ``shape`` it serves,
    and the two steps.
    Request-level serving builds ``Engine.from_lease`` instead."""

    binding: Any                       # repro_torch.pool.LeaseBinding
    shape: ShapeConfig
    prefill_step: Callable[..., Any]
    decode_step: Callable[..., Any]

    @property
    def device(self) -> torch.device:
        return self.binding.device

    @property
    def policy(self) -> TieringPolicy:
        return self.binding.policy

    @property
    def kv_spill(self) -> bool:
        return self.policy.kv_spill


def make_lease_session(model: Model, shape: ShapeConfig, lease, *,
                       device: DeviceLike = None) -> LeaseServeSession:
    """Bind a ``repro_torch.pool.Lease`` to a runnable serving session.

    The lease's ``materialize`` picks the device (``device=`` names it,
    e.g. ``"cpu"``; the default is the card) and its tier-2 reservation
    the KV spill policy.  The steps are ``make_prefill_step`` /
    ``make_decode_step`` of ``model``, which must live on that device.
    The reference also derives sharding rules for ``shape`` from the
    lease's mesh and scopes its jitted steps to them; one device has
    nothing to shard, so the port keeps ``shape`` as a record only, and
    refuses a lease whose mesh has a ``model`` axis over 1
    (``profiles.grid_refusal``)."""
    binding = lease.materialize(None if device is None else [device])
    why = grid_refusal(binding, None, serving=True)
    if why is not None:
        raise ValueError(why)
    if binding.device.type != model.device.type:
        raise ValueError(f"lease device {binding.device} differs from the "
                         f"model's {model.device}")
    return LeaseServeSession(
        binding=binding, shape=shape,
        prefill_step=make_prefill_step(model),
        decode_step=make_decode_step(model))
