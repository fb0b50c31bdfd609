"""Model API of the port (``repro.models.api``: every family).

``build_model(cfg, device=None)`` returns a ``Model`` bound to a device
(``None`` means the card, see ``repro_torch.device``):

    model.init(generator=None)           -> params in cfg.param_dtype
    model.load(params)                   -> params cast to cfg.compute_dtype
    model.loss(params, batch, remat=True) -> scalar training loss,
                                            differentiable in the fp32
                                            masters: every family (moe
                                            plus the router's aux loss,
                                            also ``groups=``; encdec's
                                            ``batch`` carries
                                            ``frame_embeds``)
    model.param_axes()                   -> the logical axes of init's tree
                                            (every family)
    model.init_cache(batch, max_seq, dtype=...) -> the family's cache
    model.cache_axes()                   -> the logical axes of its leaves
                                            (every family)
    model.prefill(params, batch, cache)  -> (last-position logits, cache
                                            [, enc_states for encdec])
    model.decode(params, tokens, cache, index[, enc_states])
                                         -> (logits, cache)
    # paged-KV serving surface (the dense and moe families):
    model.prefill_at(params, batch, cache, last_pos) -> (logits, cache)
    model.decode_paged(params, tokens, pools, page_table, lengths)
                                         -> (logits, pools)

Every call but ``init``/``load``/``loss`` takes loaded (cast)
parameters and updates the cache / pools in place.  ``init_cache``'s
default dtype is the reference's per family (bf16 for the K/V of dense,
moe, hybrid and encdec, fp32 for mamba2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, hybrid, mamba2, moe, transformer
from repro_torch.models.config import ModelConfig

_FAMILIES = {"dense": (transformer, torch.bfloat16),
             "moe": (moe, torch.bfloat16),
             "ssm": (mamba2, torch.float32),
             "hybrid": (hybrid, torch.bfloat16),
             "encdec": (encdec, torch.bfloat16)}
_PAGED = ("dense", "moe")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    load: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    loss: Callable[..., Any]
    param_axes: Callable[[], Any]
    cache_axes: Callable[[], Any]
    prefill_at: Optional[Callable[..., Any]] = None
    decode_paged: Optional[Callable[..., Any]] = None

    @property
    def supports_paged_kv(self) -> bool:
        return self.decode_paged is not None


def build_model(cfg: ModelConfig, *, device: DeviceLike = None) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)
    dev = resolve_device(device)
    m, cache_dtype = _FAMILIES[cfg.family]
    paged = {}
    if cfg.family in _PAGED:
        paged = dict(
            prefill_at=lambda p, b, c, lp: m.prefill_at(p, cfg, b, c, lp),
            decode_paged=lambda p, t, pl, pt, ln: m.decode_paged(
                p, cfg, t, pl, pt, ln))
    def loss(p, b, **kw):
        return m.loss_fn(p, cfg, b, **kw)
    if cfg.family == "encdec":
        def decode(p, t, c, i, enc):
            return m.decode_step(p, cfg, t, c, i, enc)
    else:
        def decode(p, t, c, i):
            return m.decode_step(p, cfg, t, c, i)
    return Model(
        cfg=cfg, device=dev,
        init=lambda generator=None: m.init_params(cfg, generator, dev),
        load=lambda params: transformer.cast_params(params, cfg),
        init_cache=lambda b, s, dtype=cache_dtype, device=None:
            m.init_cache(cfg, b, s, dtype=dtype,
                         device=dev if device is None else device),
        prefill=lambda p, b, c: m.prefill(p, cfg, b, c),
        decode=decode,
        loss=loss,
        param_axes=lambda: m.param_axes(cfg),
        cache_axes=((lambda: m.cache_axes(cfg)) if cfg.family == "hybrid"
                    else m.cache_axes),
        **paged,
    )
