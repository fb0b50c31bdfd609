"""Zamba2-style hybrid (port of ``repro.models.hybrid``): a Mamba2
backbone plus one SHARED transformer block run every ``attn_every``
layers, with the same weights each time and a KV cache of its own at each
invocation point.

Layer layout: ``n_layers // attn_every`` groups of [shared block,
``attn_every`` mamba layers], then the tail mamba layers.  For
zamba2-7b (81 layers, every 6) that is 13 groups and 3 tail layers, so
the shared block runs 13 times with 13 KV caches.

Parameters: ``{"embedding", "shared_attn", "mamba_main": [[block] *
per] * n_groups, "mamba_tail": [block] * tail, "final_norm"}`` (the
reference's ``(n_groups, per, ...)`` and ``(tail, ...)`` stacks
unstacked into lists).  The cache keeps the reference's stacked layout
and is updated in place.  ``loss_fn`` casts the fp32 masters inside the
graph; the shared block's gradient sums over its uses.  With ``remat``
each group (the shared block and its Mamba2 layers) is recomputed in the
backward pass, as the reference's ``jax.checkpoint`` of ``group_body``;
the tail layers are not, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def group_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, layers_per_group, tail_layers)."""
    k = cfg.attn_every
    n_groups = cfg.n_layers // k
    return n_groups, k, cfg.n_layers - n_groups * k


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and scales,
    drawn from ``generator`` on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = T.dtype_of(cfg.param_dtype)
    n_groups, per, tail = group_layout(cfg)
    p = {
        "embedding": L.init_embedding(generator, cfg.padded_vocab,
                                      cfg.d_model, dtype, dev),
        "shared_attn": T.init_block(generator, cfg, dtype, dev),
        "mamba_main": [[M.init_block(generator, cfg, dtype, dev)
                        for _ in range(per)] for _ in range(n_groups)],
        "final_norm": L.init_norm(cfg.d_model, cfg.norm_type, dtype, dev),
    }
    if tail:
        p["mamba_tail"] = [M.init_block(generator, cfg, dtype, dev)
                           for _ in range(tail)]
    return p


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """K/V in ``dtype``; the recurrent conv and SSD states always fp32."""
    dev = resolve_device(device)
    n_groups, per, tail = group_layout(cfg)
    f32 = torch.float32
    conv = (cfg.ssm_conv_width - 1, M.conv_channels(cfg))
    ssd = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    kv = (n_groups, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    c = {
        "k": torch.zeros(kv, dtype=T.dtype_of(dtype), device=dev),
        "v": torch.zeros(kv, dtype=T.dtype_of(dtype), device=dev),
        "conv": torch.zeros((n_groups, per, batch) + conv, dtype=f32,
                            device=dev),
        "ssd": torch.zeros((n_groups, per, batch) + ssd, dtype=f32,
                           device=dev),
    }
    if tail:
        c["conv_tail"] = torch.zeros((tail, batch) + conv, dtype=f32,
                                     device=dev)
        c["ssd_tail"] = torch.zeros((tail, batch) + ssd, dtype=f32,
                                    device=dev)
    return c


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_index: Optional[int] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (hidden_states, cache); the cache is updated in place.
    ``remat`` (no cache) recomputes each group in the backward pass."""
    x = T._embed_inputs(params, cfg, batch)
    S = x.shape[1]
    start = 0 if cache_index is None else cache_index
    positions = (start + torch.arange(S, device=x.device))[None, :]
    shared = params["shared_attn"]

    def group_fwd(h, group):
        h = T.block_fwd(shared, h, cfg, positions=positions)
        for layer in group:
            h = M.block_fwd(layer, h, cfg)[0]
        return h

    for g, group in enumerate(params["mamba_main"]):
        if cache is None:
            x = (T.remat(lambda h, group=group: group_fwd(h, group), x)
                 if remat else group_fwd(x, group))
            continue
        x = T.block_fwd(shared, x, cfg, positions=positions,
                        kv_cache=(cache["k"][g], cache["v"][g]),
                        cache_index=cache_index)
        for j, layer in enumerate(group):
            x = M.apply_block(layer, x, cfg, cache["conv"][g, j],
                              cache["ssd"][g, j])
    for j, layer in enumerate(params.get("mamba_tail", [])):
        x = M.apply_block(layer, x, cfg,
                          None if cache is None else cache["conv_tail"][j],
                          None if cache is None else cache["ssd_tail"][j])
    return L.apply_norm(x, params["final_norm"], cfg.norm_type), cache


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = True) -> torch.Tensor:
    """``transformer.lm_loss`` through this family's ``forward``."""
    return T.lm_loss(forward, params, cfg, batch, remat)


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt, filling the cache; logits of the last position."""
    hidden, cache = forward(params, cfg, batch, cache=cache, cache_index=0)
    return T.logits_fn(params, cfg, hidden[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: tokens (B, 1); ``cache_index`` is the length so
    far, where the shared block writes its new K/V."""
    hidden, cache = forward(params, cfg, {"tokens": tokens}, cache=cache,
                            cache_index=cache_index)
    return T.logits_fn(params, cfg, hidden), cache
