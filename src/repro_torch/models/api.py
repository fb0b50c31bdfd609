"""Model API of the port (the dense, ssm and hybrid branches of
``repro.models.api``).

``build_model(cfg, device=None)`` returns a ``Model`` bound to a device
(``None`` means the card, see ``repro_torch.device``):

    model.init(generator=None)           -> params in cfg.param_dtype
    model.load(params)                   -> params cast to cfg.compute_dtype
    model.init_cache(batch, max_seq, dtype=...) -> the family's cache
    model.prefill(params, batch, cache)  -> (last-position logits, cache)
    model.decode(params, tokens, cache, index) -> (logits, cache)
    # paged-KV serving surface (the dense family only):
    model.prefill_at(params, batch, cache, last_pos) -> (logits, cache)
    model.decode_paged(params, tokens, pools, page_table, lengths)
                                         -> (logits, pools)

Every call but ``init``/``load`` takes loaded (cast) parameters and
updates the cache / pools in place.  ``init_cache``'s default dtype is
the reference's per family (bf16 for dense and hybrid K/V, fp32 for
mamba2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid, mamba2, transformer
from repro_torch.models.config import ModelConfig

_FAMILIES = {"dense": (transformer, torch.bfloat16),
             "ssm": (mamba2, torch.float32),
             "hybrid": (hybrid, torch.bfloat16)}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    load: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    prefill_at: Optional[Callable[..., Any]] = None
    decode_paged: Optional[Callable[..., Any]] = None

    @property
    def supports_paged_kv(self) -> bool:
        return self.decode_paged is not None


def build_model(cfg: ModelConfig, *, device: DeviceLike = None) -> Model:
    dev = resolve_device(device)
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the port serves the dense, ssm and hybrid families so far, "
            f"not {cfg.family!r}")
    m, cache_dtype = _FAMILIES[cfg.family]
    paged = {}
    if cfg.family == "dense":
        paged = dict(
            prefill_at=lambda p, b, c, lp: m.prefill_at(p, cfg, b, c, lp),
            decode_paged=lambda p, t, pl, pt, ln: m.decode_paged(
                p, cfg, t, pl, pt, ln))
    return Model(
        cfg=cfg, device=dev,
        init=lambda generator=None: m.init_params(cfg, generator, dev),
        load=lambda params: transformer.cast_params(params, cfg),
        init_cache=lambda b, s, dtype=cache_dtype, device=None:
            m.init_cache(cfg, b, s, dtype=dtype,
                         device=dev if device is None else device),
        prefill=lambda p, b, c: m.prefill(p, cfg, b, c),
        decode=lambda p, t, c, i: m.decode_step(p, cfg, t, c, i),
        **paged,
    )
