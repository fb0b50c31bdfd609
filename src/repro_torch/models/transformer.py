"""Dense decoder-only transformer LM (port of ``repro.models.transformer``):
qwen1.5 / qwen3 / command-r / olmo / pixtral-backbone, with GQA, RoPE and
optional QKV-bias / qk-norm / parallel-block / non-parametric-LN variants.

Parameters are ``{"embedding": {"table"}, "layers": [block dict per
layer], "final_norm": {...}}``: the reference's tree with its stacked
``(L, ...)`` layer leaves unstacked into a list, walked by a Python
loop in place of ``lax.scan``.  For serving, ``cast_params`` runs once at
load (``Model.load``) and the forward functions take parameters already
in the compute dtype; ``loss_fn`` takes the fp32 masters and casts them
inside, so the gradients reach the masters.  KV caches and page pools
are updated in place.

Under a tensor-parallel / FSDP plan (``repro_torch.sharding.tp``: the
rules and rank grid of the training step, or of the serving engine on a
``model``-axis lease) the parameters are this rank's blocks
(``param_axes``, the reference's logical names): attention runs on
``n_heads / model`` and ``n_kv_heads / model`` local heads (the KV
caches and page pools hold the local kv heads, ``cache_axes``), the MLP
is Megatron column -> row over ``ff``, the table's vocab rows are split
over ``model`` (the lookup, the loss and the logits are vocab-parallel:
``prefill_at`` and ``decode_paged`` return the rank's columns), and
FSDP's ``embed``-sharded leaves are gathered over ``data`` where they
are used: a layer's at the top of ``block_fwd`` (again in a remat
recompute), the table once a step in ``lm_loss``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import partition, tp

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


def block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    p = {
        "attn": L.attention_axes(attn_config(cfg)),
        "mlp": L.mlp_axes(mlp_config(cfg)),
        "norm1": L.norm_axes(cfg.norm_type),
    }
    if not cfg.parallel_block:
        p["norm2"] = L.norm_axes(cfg.norm_type)
    return p


def _mlp(params, h, cfg: ModelConfig, plan) -> torch.Tensor:
    """The MLP, column -> row parallel over ``model`` under a plan."""
    out = L.mlp_fwd(params["mlp"], tp.copy_to_model(h, plan),
                    mlp_config(cfg))
    return tp.reduce_from_model(out, plan)


def _mlp_residual(params, x, h, attn_out, cfg: ModelConfig, plan=None):
    if cfg.parallel_block:
        # command-r style: MLP reads the same normed input, outputs add
        return x + attn_out + _mlp(params, h, cfg, plan)
    x = x + attn_out
    h2 = L.apply_norm(x, params["norm2"], cfg.norm_type)
    return x + _mlp(params, h2, cfg, plan)


def attention(params, x: torch.Tensor, cfg: ModelConfig, plan, *,
              positions: torch.Tensor, kv_cache=None,
              cache_index: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(norm1(x), the block's attention output): under a plan on the
    rank's local heads, its input behind ``copy_to_model`` and its
    output summed over ``model`` (the dense and moe blocks)."""
    acfg = attn_config(cfg)
    if plan is not None:
        acfg = plan.local_attention(acfg)
    h = L.apply_norm(x, params["norm1"], cfg.norm_type)
    attn_out, _ = L.attention_fwd(params["attn"], tp.copy_to_model(h, plan),
                                  acfg, positions=positions,
                                  kv_cache=kv_cache, cache_index=cache_index)
    return h, tp.reduce_from_model(attn_out, plan)


def attention_paged(params, x: torch.Tensor, cfg: ModelConfig, plan, *,
                    positions: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attention`` for decode over a paged KV pool (one token a row):
    under a plan the rank's local heads over its pages (its kv heads)."""
    acfg = attn_config(cfg)
    if plan is not None:
        acfg = plan.local_attention(acfg)
    h = L.apply_norm(x, params["norm1"], cfg.norm_type)
    attn_out = L.attention_fwd_paged(
        params["attn"], tp.copy_to_model(h, plan), acfg,
        positions=positions, k_pages=k_pages, v_pages=v_pages,
        page_table=page_table, lengths=lengths)
    return h, tp.reduce_from_model(attn_out, plan)


def block_fwd(params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, kv_cache=None,
              cache_index: Optional[int] = None) -> torch.Tensor:
    plan = tp.plan()
    if plan is not None:
        params = tp.gather_params(params, block_axes(cfg), plan,
                                  dtype_of(cfg.compute_dtype))
    h, attn_out = attention(params, x, cfg, plan, positions=positions,
                            kv_cache=kv_cache, cache_index=cache_index)
    return _mlp_residual(params, x, h, attn_out, cfg, plan)


def block_fwd_paged(params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """``block_fwd`` for decode over a paged KV pool (one token/row);
    under a plan, attention on the rank's local heads over its pages
    (its kv heads) and the MLP column -> row, as ``block_fwd``."""
    plan = tp.plan()
    h, attn_out = attention_paged(
        params, x, cfg, plan, positions=positions, k_pages=k_pages,
        v_pages=v_pages, page_table=page_table, lengths=lengths)
    return _mlp_residual(params, x, h, attn_out, cfg, plan)


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


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of ``init_params``' tree, leaf for leaf (the
    reference's names; ``layers`` is the port's list, with no leading
    ``("layers",)`` axis)."""
    return {
        "embedding": L.embedding_axes(),
        "layers": [block_axes(cfg) for _ in range(cfg.n_layers)],
        "final_norm": L.norm_axes(cfg.norm_type),
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
    plan = tp.plan()
    if plan is not None:
        return tp.vocab_embed(params["embedding"]["table"], batch["tokens"],
                              plan).to(compute)
    return L.embed(params["embedding"], batch["tokens"]).to(compute)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_index: Optional[int] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (hidden_states, cache); the cache is filled in place.
    ``remat`` (no cache) recomputes each layer in the backward pass
    instead of saving its activations, as the reference's
    ``jax.checkpoint(..., nothing_saveable)`` layer body does."""
    x = _embed_inputs(params, cfg, batch)
    S = x.shape[1]
    start = 0 if cache_index is None else cache_index
    positions = (start + torch.arange(S, device=x.device))[None, :]
    for i, layer in enumerate(params["layers"]):
        if remat and cache is None:
            x = _remat_block(layer, x, cfg, positions)
            continue
        kv = None if cache is None else (cache["k"][i], cache["v"][i])
        x = block_fwd(layer, x, cfg, positions=positions, kv_cache=kv,
                      cache_index=cache_index)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    return x, cache


def remat(fn, x: torch.Tensor):
    """``fn(x)`` whose activations are recomputed in the backward pass
    (the reference's ``jax.checkpoint(..., nothing_saveable)`` layer
    body), through the same kernels or plain versions as this forward,
    under the same rules, grid and row split: the recompute runs on
    autograd's thread, where the caller's ``plain_versions()``,
    ``use_rules`` and ``tp.split_rows`` are not set, so all three are
    read here."""
    plain = ops.plain_enabled()
    rules, mesh = partition.current_rules(), partition.current_mesh()
    split = tp.row_split()

    def body(h):
        with ops.plain_versions() if plain else contextlib.nullcontext(), \
                partition.use_rules(rules, mesh), tp.split_rows(split):
            return fn(h)

    return checkpoint(body, x, use_reentrant=False)


def _remat_block(layer, x, cfg: ModelConfig, positions) -> torch.Tensor:
    return remat(lambda h: block_fwd(layer, h, cfg, positions=positions), x)


def logits_fn(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Logits of ``hidden``; under a plan the rank's columns of the
    padded vocab (``layers.unembed``)."""
    return L.unembed(params["embedding"], hidden, cfg.vocab, tp.plan())


def lm_loss(forward_fn, params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], remat: bool, *,
            aux_coef: Optional[float] = None,
            axes_fn=None) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` ({"tokens", "labels"}
    and an optional "mask") through a family's ``forward_fn`` (returning
    hidden states first), differentiable in the masters ``params``: they
    are cast to the compute dtype here, inside the graph, as the
    reference's ``forward`` casts them.  ``aux_coef``: plus that times
    the last thing ``forward_fn`` returns (the moe family's
    load-balancing loss).  Under a plan (``repro_torch.sharding.tp``;
    every family, ``axes_fn(cfg)`` the family's ``param_axes``) the lookup and the loss are vocab-parallel
    and the table is gathered once."""
    plan = tp.plan()
    if plan is not None:
        dtype = dtype_of(cfg.compute_dtype)
        axes = (axes_fn or param_axes)(cfg)
        params = tp.cast_params(params, axes, plan, dtype)
        params["embedding"] = tp.gather_params(params["embedding"],
                                               axes["embedding"], plan, dtype)
    else:
        params = cast_params(params, cfg)
    out = forward_fn(params, cfg, batch, remat=remat)
    if plan is not None:
        logits = L.unembed(params["embedding"], out[0], plan=plan)
        loss = tp.vocab_parallel_cross_entropy(
            logits, batch["labels"], batch.get("mask"), cfg.vocab, plan)
    else:
        logits = logits_fn(params, cfg, out[0])
        loss = L.cross_entropy_loss(logits, batch["labels"],
                                    batch.get("mask"))
    return loss if aux_coef is None else loss + aux_coef * out[-1]


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = True) -> torch.Tensor:
    """``lm_loss`` of the dense family."""
    return lm_loss(forward, params, cfg, batch, remat)


# ---------------------------------------------------------------------------
# KV cache management
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """Zero K/V caches (L, batch, max_seq, KV, hd); under a plan the
    rank's kv heads, ``KV / model`` (``cache_axes``: ``kv_heads``)."""
    dev = resolve_device(device)
    plan = tp.plan()
    kv = cfg.n_kv_heads // (plan.model_n if plan is not None else 1)
    shape = (cfg.n_layers, batch, max_seq, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(dtype), device=dev),
            "v": torch.zeros(shape, dtype=dtype_of(dtype), device=dev)}


def cache_axes() -> Dict[str, Any]:
    """The logical axes of ``init_cache``'s leaves (and of the engine's
    page pools, whose ``batch`` is the page and ``seq_kv`` the slot in
    it): the reference's."""
    ax = ("layers", "batch", "seq_kv", "kv_heads", "head_dim")
    return {"k": ax, "v": ax}


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
    entries).  Returns (logits (B, 1, V), pools); under a plan the pools
    hold the rank's kv heads and the logits are its columns of the
    padded vocab.
    """
    x = _embed_inputs(params, cfg, {"tokens": tokens})
    positions = lengths.long()[:, None]                     # (B, 1)
    for i, layer in enumerate(params["layers"]):
        x = block_fwd_paged(layer, x, cfg, positions=positions,
                            k_pages=pools["k"][i], v_pages=pools["v"][i],
                            page_table=page_table, lengths=lengths)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    return logits_fn(params, cfg, x), pools
