"""Dense decoder-only transformer LM (port of ``repro.models.transformer``):
qwen1.5 / qwen3 / command-r / olmo / pixtral-backbone, with GQA, RoPE and
optional QKV-bias / qk-norm / parallel-block / non-parametric-LN variants.

Parameters are ``{"embedding": {"table"}, "layers": [block dict per
layer], "final_norm": {...}}``: the reference's tree with its stacked
``(L, ...)`` layer leaves unstacked into a list, walked by a Python
loop in place of ``lax.scan``.  ``cast_params`` runs once at load
(``Model.load``); the forward functions take parameters already in the
compute dtype.  KV caches and page pools are updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def attn_config(cfg: ModelConfig, *, causal: bool = True,
                use_rope: bool = True) -> L.AttentionConfig:
    return L.AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, sliding_window=cfg.sliding_window,
        causal=causal, use_rope=use_rope, norm_eps=cfg.norm_eps)


def mlp_config(cfg: ModelConfig) -> L.MLPConfig:
    return L.MLPConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       activation=cfg.mlp_activation, gated=cfg.mlp_gated)


# ---------------------------------------------------------------------------
# one transformer block
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    p = {
        "attn": L.init_attention(gen, attn_config(cfg), dtype, device),
        "mlp": L.init_mlp(gen, mlp_config(cfg), dtype, device),
        "norm1": L.init_norm(cfg.d_model, cfg.norm_type, dtype, device),
    }
    if not cfg.parallel_block:
        p["norm2"] = L.init_norm(cfg.d_model, cfg.norm_type, dtype, device)
    return p


def _mlp_residual(params, x, h, attn_out, cfg: ModelConfig):
    if cfg.parallel_block:
        # command-r style: MLP reads the same normed input, outputs add
        return x + attn_out + L.mlp_fwd(params["mlp"], h, mlp_config(cfg))
    x = x + attn_out
    h2 = L.apply_norm(x, params["norm2"], cfg.norm_type)
    return x + L.mlp_fwd(params["mlp"], h2, mlp_config(cfg))


def block_fwd(params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, kv_cache=None,
              cache_index: Optional[int] = None) -> torch.Tensor:
    h = L.apply_norm(x, params["norm1"], cfg.norm_type)
    attn_out, _ = L.attention_fwd(params["attn"], h, attn_config(cfg),
                                  positions=positions, kv_cache=kv_cache,
                                  cache_index=cache_index)
    return _mlp_residual(params, x, h, attn_out, cfg)


def block_fwd_paged(params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """``block_fwd`` for decode over a paged KV pool (one token/row)."""
    h = L.apply_norm(x, params["norm1"], cfg.norm_type)
    attn_out = L.attention_fwd_paged(
        params["attn"], h, attn_config(cfg), positions=positions,
        k_pages=k_pages, v_pages=v_pages, page_table=page_table,
        lengths=lengths)
    return _mlp_residual(params, x, h, attn_out, cfg)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and scales
    (``transformer.init_params``/``layers`` initializers), drawn from
    ``generator`` on ``device``.  The numbers differ from the
    reference's ``jax.random`` draws; use ``repro_torch.bridge`` where
    the two must hold the same weights."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = dtype_of(cfg.param_dtype)
    return {
        "embedding": L.init_embedding(generator, cfg.padded_vocab,
                                      cfg.d_model, dtype, dev),
        "layers": [init_block(generator, cfg, dtype, dev)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.init_norm(cfg.d_model, cfg.norm_type, dtype, dev),
    }


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def cast_params(params, cfg: ModelConfig):
    """Cast float parameters to the compute dtype, once, at load."""
    dtype = dtype_of(cfg.compute_dtype)
    return _map(params, lambda w: w.to(dtype) if w.is_floating_point()
                else w)


def _embed_inputs(params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embedding, or precomputed frontend embeddings (vlm stub)."""
    compute = dtype_of(cfg.compute_dtype)
    if "embeds" in batch:
        return batch["embeds"].to(compute)
    return L.embed(params["embedding"], batch["tokens"]).to(compute)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_index: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (hidden_states, cache); the cache is filled in place."""
    x = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    start = 0 if cache_index is None else cache_index
    positions = (start + torch.arange(S, device=x.device))[None, :]
    for i, layer in enumerate(params["layers"]):
        kv = None if cache is None else (cache["k"][i], cache["v"][i])
        x = block_fwd(layer, x, cfg, positions=positions, kv_cache=kv,
                      cache_index=cache_index)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    return x, cache


def logits_fn(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    return L.unembed(params["embedding"], hidden, cfg.vocab)


# ---------------------------------------------------------------------------
# KV cache management
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(dtype), device=dev),
            "v": torch.zeros(shape, dtype=dtype_of(dtype), device=dev)}


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt through the model, filling the contiguous cache;
    returns logits of the last position."""
    hidden, cache = forward(params, cfg, batch, cache=cache, cache_index=0)
    return logits_fn(params, cfg, hidden[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode over the contiguous cache: tokens (B, 1);
    ``cache_index`` is the current length (the write position)."""
    hidden, cache = forward(params, cfg, {"tokens": tokens}, cache=cache,
                            cache_index=cache_index)
    return logits_fn(params, cfg, hidden), cache


def prefill_at(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               cache: Dict[str, torch.Tensor], last_pos: int,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bucketed prefill: the prompt is right-padded to a bucket length,
    so the true next-token distribution sits at ``last_pos`` (the last
    *real* position), not at the padded end.  Causality keeps real
    positions blind to the trailing pads; pad K/V beyond ``last_pos``
    is garbage the consumer must mask (the paged engine never copies
    or attends past the real prompt length)."""
    hidden, cache = forward(params, cfg, batch, cache=cache, cache_index=0)
    h_last = hidden[:, last_pos:last_pos + 1]
    return logits_fn(params, cfg, h_last), cache


def decode_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                 pools: Dict[str, torch.Tensor], page_table: torch.Tensor,
                 lengths: torch.Tensor,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode over the shared paged KV pool.

    tokens: (B, 1); pools: {"k","v"} each (L, P, ps, KV, hd) — the
    device-side physical page pool shared by every sequence, updated in
    place; page_table: (B, PMAX) int32 logical->physical; lengths: (B,)
    int32 current KV length per row (idle rows: 0 + trash-page table
    entries).  Returns (logits (B, 1, V), pools).
    """
    x = _embed_inputs(params, cfg, {"tokens": tokens})
    positions = lengths.long()[:, None]                     # (B, 1)
    for i, layer in enumerate(params["layers"]):
        x = block_fwd_paged(layer, x, cfg, positions=positions,
                            k_pages=pools["k"][i], v_pages=pools["v"][i],
                            page_table=page_table, lengths=lengths)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    return logits_fn(params, cfg, x), pools
