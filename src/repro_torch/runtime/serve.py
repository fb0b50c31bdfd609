"""Fixed-batch serving steps (port of ``repro.runtime.serve``): a prefill
and a one-token greedy decode step over a model's contiguous cache, the
path every family the port builds is served through (ssm and hybrid
have no paged KV, so the request-level engine does not take them).

    prefill_step(params, batch, cache) -> (next_token_logits, cache)
    decode_step(params, carry)         -> (logits, new_carry)

The carry is ``{"tokens": (B, 1) long, "cache": ..., "index": int}``;
the cache is updated in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.api import Model


def make_prefill_step(model: Model) -> Callable[..., Any]:
    """prefill_step(params, batch, cache) -> (next_token_logits, cache)."""

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(model: Model) -> Callable[..., Any]:
    """decode_step(params, carry) -> (logits, new_carry): one token for
    every row, greedy-sampled into the carry so the step is
    self-contained for a generation loop."""

    def decode_step(params, carry: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        logits, cache = model.decode(params, carry["tokens"], carry["cache"],
                                     carry["index"])
        new_carry = dict(carry)
        new_carry.update(tokens=torch.argmax(logits[:, -1, :], dim=-1)[:, None],
                         cache=cache, index=carry["index"] + 1)
        return logits, new_carry

    return decode_step
