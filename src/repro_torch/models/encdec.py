"""Whisper-style encoder-decoder backbone (port of
``repro.models.encdec``), audio frontend stubbed.

The frontend is a stub: the caller passes precomputed frame embeddings
(B, enc_seq, d_model).  The encoder runs bidirectional attention over the
frames; the decoder is a causal LM with cross-attention into the encoder
states.  Pre-LayerNorm (plain PyTorch: LayerNorm is no kernel of the
reference), ungated GELU MLPs, QKV bias, no RoPE: sinusoidal positions
are added to the inputs.  Every attention (the encoder's, the decoder's
causal self-attention over its cache and its cross-attention) runs
through the flash kernel.

Parameters are ``{"embedding", "enc_layers": [block] * n_enc_layers,
"dec_layers": [block] * n_layers, "enc_norm", "dec_norm"}``: the
reference's stacked layer leaves unstacked into lists.  Like the
reference, every decode step recomputes each layer's cross-attention
K/V from the encoder states.  The decoder's KV cache is the dense
transformer's layout, updated in place.  ``loss_fn`` is the reference's
cross entropy of the decoder over a batch of ``frame_embeds``,
``tokens`` and ``labels``, with remat per layer in both stacks.

Under a tensor-parallel / FSDP plan (``repro_torch.sharding.tp``) the
parameters are this rank's blocks (``param_axes``, the reference's
names): each attention (the encoder's, the decoder's causal
self-attention over its cache of the rank's kv heads, its
cross-attention) runs on the rank's local heads behind
``copy_to_model`` and ``reduce_from_model``, the MLP is column -> row
over ``ff``, the LayerNorms stay whole, the decoder's lookup, logits and
loss are vocab-parallel, and FSDP's leaves are gathered inside each
block (again in a remat recompute).  The cross-attention K/V are
computed outside the remat, as the reference computes them before its
layer scan: a layer's ``wk``, ``wv``, ``bk`` and ``bv`` are gathered
there alone, and the encoder states go behind one ``copy_to_model``
(counted as ``cross``) shared by every decoder layer, so their gradient
is summed over ``model`` once a step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import tp

_NORM = "layernorm"
# the cross-attention leaves ``cross_kv`` reads, outside the remat
_CROSS_KV = ("wk", "wv", "bk", "bv")


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions: (S,) -> (S, d) float32."""
    half = d // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    neg_log = -torch.log(torch.tensor(10000.0, device=positions.device))
    freqs = torch.exp(neg_log * idx / max(1, half - 1))
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_cfg(cfg: ModelConfig, *, causal: bool) -> L.AttentionConfig:
    return L.AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=True, qk_norm=False,
        causal=causal, use_rope=False, norm_eps=cfg.norm_eps)


def _mlp_cfg(cfg: ModelConfig) -> L.MLPConfig:
    return L.MLPConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       activation="gelu", gated=False)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def init_enc_block(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    return {
        "attn": L.init_attention(gen, _attn_cfg(cfg, causal=False), dtype,
                                 device),
        "mlp": L.init_mlp(gen, _mlp_cfg(cfg), dtype, device),
        "norm1": L.init_norm(cfg.d_model, _NORM, dtype, device),
        "norm2": L.init_norm(cfg.d_model, _NORM, dtype, device),
    }


def init_dec_block(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    return {
        "self_attn": L.init_attention(gen, _attn_cfg(cfg, causal=True),
                                      dtype, device),
        "cross_attn": L.init_attention(gen, _attn_cfg(cfg, causal=False),
                                       dtype, device),
        "mlp": L.init_mlp(gen, _mlp_cfg(cfg), dtype, device),
        "norm1": L.init_norm(cfg.d_model, _NORM, dtype, device),
        "norm2": L.init_norm(cfg.d_model, _NORM, dtype, device),
        "norm3": L.init_norm(cfg.d_model, _NORM, dtype, device),
    }


def enc_block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "attn": L.attention_axes(_attn_cfg(cfg, causal=False)),
        "mlp": L.mlp_axes(_mlp_cfg(cfg)),
        "norm1": L.norm_axes(_NORM),
        "norm2": L.norm_axes(_NORM),
    }


def dec_block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "self_attn": L.attention_axes(_attn_cfg(cfg, causal=True)),
        "cross_attn": L.attention_axes(_attn_cfg(cfg, causal=False)),
        "mlp": L.mlp_axes(_mlp_cfg(cfg)),
        "norm1": L.norm_axes(_NORM),
        "norm2": L.norm_axes(_NORM),
        "norm3": L.norm_axes(_NORM),
    }


def _gathered(params, axes, cfg: ModelConfig, plan):
    """The leaves of ``axes`` as the rank uses them
    (``tp.gather_params``)."""
    return tp.gather_params(params, axes, plan, T.dtype_of(cfg.compute_dtype))


def _attention(params, h: torch.Tensor, acfg: L.AttentionConfig, plan,
               **kw) -> torch.Tensor:
    """An attention on the rank's local heads under a plan: its input
    behind ``copy_to_model``, its output summed over ``model``."""
    if plan is not None:
        acfg = plan.local_attention(acfg)
    out, _ = L.attention_fwd(params, tp.copy_to_model(h, plan), acfg, **kw)
    return tp.reduce_from_model(out, plan)


def _mlp(params, h: torch.Tensor, cfg: ModelConfig, plan) -> torch.Tensor:
    out = L.mlp_fwd(params, tp.copy_to_model(h, plan), _mlp_cfg(cfg))
    return tp.reduce_from_model(out, plan)


def enc_block_fwd(params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    plan = tp.plan()
    if plan is not None:
        params = _gathered(params, enc_block_axes(cfg), cfg, plan)
    h = L.apply_norm(x, params["norm1"], _NORM)
    x = x + _attention(params["attn"], h, _attn_cfg(cfg, causal=False), plan,
                       positions=positions)
    h = L.apply_norm(x, params["norm2"], _NORM)
    return x + _mlp(params["mlp"], h, cfg, plan)


def dec_block_fwd(params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor,
                  enc_kv: Tuple[torch.Tensor, torch.Tensor],
                  kv_cache=None, cache_index: Optional[int] = None
                  ) -> torch.Tensor:
    """enc_kv: (k, v) of this layer's cross-attention (``cross_kv``);
    the self-attention cache is written in place.  Under a plan the
    layer's leaves but the cross K/V's are gathered here."""
    plan = tp.plan()
    if plan is not None:
        axes = dec_block_axes(cfg)
        axes["cross_attn"] = {k: v for k, v in axes["cross_attn"].items()
                              if k not in _CROSS_KV}
        params = _gathered(params, axes, cfg, plan)
    h = L.apply_norm(x, params["norm1"], _NORM)
    x = x + _attention(params["self_attn"], h, _attn_cfg(cfg, causal=True),
                       plan, positions=positions, kv_cache=kv_cache,
                       cache_index=cache_index)
    h = L.apply_norm(x, params["norm2"], _NORM)
    x = x + _attention(params["cross_attn"], h,
                       _attn_cfg(cfg, causal=False), plan,
                       positions=positions, kv_override=enc_kv)
    h = L.apply_norm(x, params["norm3"], _NORM)
    return x + _mlp(params["mlp"], h, cfg, plan)


def cross_kv(params, cfg: ModelConfig, enc_states: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of one decoder layer from the encoder
    states: each (B, enc_seq, KV, hd); under a plan the rank's kv heads,
    from its blocks of ``wk``, ``wv``, ``bk`` and ``bv`` (gathered here
    under FSDP).  ``enc_states`` go in as every rank of a ``model``
    group holds them (``decode`` puts them behind ``copy_to_model``)."""
    B, S, _ = enc_states.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    p = params["cross_attn"]
    plan = tp.plan()
    if plan is not None:
        axes = L.attention_axes(_attn_cfg(cfg, causal=False))
        p = _gathered({k: p[k] for k in _CROSS_KV},
                      {k: axes[k] for k in _CROSS_KV}, cfg, plan)
        KV //= plan.model_n
    k = (enc_states @ p["wk"] + p["bk"]).reshape(B, S, KV, hd)
    v = (enc_states @ p["wv"] + p["bv"]).reshape(B, S, KV, hd)
    return k, v


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and scales,
    drawn from ``generator`` on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = T.dtype_of(cfg.param_dtype)
    return {
        "embedding": L.init_embedding(generator, cfg.padded_vocab,
                                      cfg.d_model, dtype, dev),
        "enc_layers": [init_enc_block(generator, cfg, dtype, dev)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [init_dec_block(generator, cfg, dtype, dev)
                       for _ in range(cfg.n_layers)],
        "enc_norm": L.init_norm(cfg.d_model, _NORM, dtype, dev),
        "dec_norm": L.init_norm(cfg.d_model, _NORM, dtype, dev),
    }


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of ``init_params``' tree, leaf for leaf (the
    reference's names; the port's lists have no leading ``("layers",)``
    axis)."""
    return {
        "embedding": L.embedding_axes(),
        "enc_layers": [enc_block_axes(cfg) for _ in range(cfg.n_enc_layers)],
        "dec_layers": [dec_block_axes(cfg) for _ in range(cfg.n_layers)],
        "enc_norm": L.norm_axes(_NORM),
        "dec_norm": L.norm_axes(_NORM),
    }


def encode(params, cfg: ModelConfig, frame_embeds: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frame_embeds: (B, enc_seq, d_model), the stub frontend's output ->
    encoder states in the compute dtype.  ``remat`` recomputes each
    layer in the backward pass."""
    dtype = T.dtype_of(cfg.compute_dtype)
    S = frame_embeds.shape[1]
    positions = torch.arange(S, device=frame_embeds.device)
    x = frame_embeds.to(dtype) + _sinusoidal(positions,
                                              cfg.d_model).to(dtype)[None]
    for layer in params["enc_layers"]:
        def block(h, layer=layer):
            return enc_block_fwd(layer, h, cfg, positions[None, :])
        x = T.remat(block, x) if remat else block(x)
    return L.apply_norm(x, params["enc_norm"], _NORM)


def decode(params, cfg: ModelConfig, tokens: torch.Tensor,
           enc_states: torch.Tensor, *,
           cache: Optional[Dict[str, torch.Tensor]] = None,
           cache_index: Optional[int] = None,
           remat: bool = False) -> torch.Tensor:
    """The decoder over ``tokens`` (B, S) from position ``cache_index``
    (0 without a cache); returns the normed hidden states.  ``remat``
    (no cache) recomputes each layer in the backward pass; the
    cross-attention K/V are computed outside it and kept, as the
    reference computes them before its layer scan.  Under a plan the
    lookup is vocab-parallel and ``enc_states`` go behind one
    ``copy_to_model`` for every layer's cross K/V."""
    dtype = T.dtype_of(cfg.compute_dtype)
    S = tokens.shape[1]
    start = 0 if cache_index is None else cache_index
    positions = start + torch.arange(S, device=tokens.device)
    x = T._embed_inputs(params, cfg, {"tokens": tokens})
    x = x + _sinusoidal(positions, cfg.d_model).to(dtype)[None]
    enc_states = tp.copy_to_model(enc_states, tp.plan(), what="cross")
    for i, layer in enumerate(params["dec_layers"]):
        kv = None if cache is None else (cache["k"][i], cache["v"][i])
        enc_kv = cross_kv(layer, cfg, enc_states)

        def block(h, layer=layer, kv=kv, enc_kv=enc_kv):
            return dec_block_fwd(layer, h, cfg, positions=positions[None, :],
                                 enc_kv=enc_kv, kv_cache=kv,
                                 cache_index=cache_index)
        x = T.remat(block, x) if remat and cache is None else block(x)
    return L.apply_norm(x, params["dec_norm"], _NORM)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_index: Optional[int] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                       torch.Tensor]:
    """batch: {frame_embeds, tokens} or, to decode, {tokens, enc_states}.
    Returns (hidden_states, cache, enc_states)."""
    if "enc_states" in batch:
        enc_states = batch["enc_states"]
    else:
        enc_states = encode(params, cfg, batch["frame_embeds"], remat=remat)
    hidden = decode(params, cfg, batch["tokens"], enc_states, cache=cache,
                    cache_index=cache_index, remat=remat)
    return hidden, cache, enc_states


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = True) -> torch.Tensor:
    """``transformer.lm_loss`` of the decoder over ``batch``
    ({"frame_embeds", "tokens", "labels"} and an optional "mask"),
    vocab-parallel under a plan."""
    return T.lm_loss(forward, params, cfg, batch, remat,
                     axes_fn=param_axes)


init_cache = T.init_cache
cache_axes = T.cache_axes


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """Encode the frames, run the prompt through the decoder filling its
    cache; returns (last-position logits, cache, enc_states)."""
    hidden, cache, enc_states = forward(params, cfg, batch, cache=cache,
                                        cache_index=0)
    return T.logits_fn(params, cfg, hidden[:, -1:]), cache, enc_states


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int,
                enc_states: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    hidden, cache, _ = forward(
        params, cfg, {"tokens": tokens, "enc_states": enc_states},
        cache=cache, cache_index=cache_index)
    return T.logits_fn(params, cfg, hidden), cache
