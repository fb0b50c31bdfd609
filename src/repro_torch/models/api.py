"""Model API of the port (the dense branch of ``repro.models.api``).

``build_model(cfg, device=None)`` returns a ``Model`` bound to a device
(``None`` means the card, see ``repro_torch.device``):

    model.init(generator=None)           -> params in cfg.param_dtype
    model.load(params)                   -> params cast to cfg.compute_dtype
    model.init_cache(batch, max_seq, dtype=...) -> {"k","v"} cache
    model.prefill_at(params, batch, cache, last_pos) -> (logits, cache)
    model.decode_paged(params, tokens, pools, page_table, lengths)
                                         -> (logits, pools)

``prefill_at`` and ``decode_paged`` take loaded (cast) parameters and
update the cache / pools in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    load: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill_at: Optional[Callable[..., Any]] = None
    decode_paged: Optional[Callable[..., Any]] = None

    @property
    def supports_paged_kv(self) -> bool:
        return self.decode_paged is not None


def build_model(cfg: ModelConfig, *, device: DeviceLike = None) -> Model:
    dev = resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port serves the dense family so far, not {cfg.family!r}")
    m = transformer
    return Model(
        cfg=cfg, device=dev,
        init=lambda generator=None: m.init_params(cfg, generator, dev),
        load=lambda params: m.cast_params(params, cfg),
        init_cache=lambda b, s, dtype=torch.bfloat16, device=None:
            m.init_cache(cfg, b, s, dtype=dtype,
                         device=dev if device is None else device),
        prefill_at=lambda p, b, c, lp: m.prefill_at(p, cfg, b, c, lp),
        decode_paged=lambda p, t, pl, pt, ln: m.decode_paged(
            p, cfg, t, pl, pt, ln),
    )
