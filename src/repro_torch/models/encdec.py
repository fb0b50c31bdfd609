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
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

_NORM = "layernorm"


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


def enc_block_fwd(params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(x, params["norm1"], _NORM)
    attn, _ = L.attention_fwd(params["attn"], h,
                              _attn_cfg(cfg, causal=False),
                              positions=positions)
    x = x + attn
    h = L.apply_norm(x, params["norm2"], _NORM)
    return x + L.mlp_fwd(params["mlp"], h, _mlp_cfg(cfg))


def dec_block_fwd(params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor,
                  enc_kv: Tuple[torch.Tensor, torch.Tensor],
                  kv_cache=None, cache_index: Optional[int] = None
                  ) -> torch.Tensor:
    """enc_kv: (k, v) of this layer's cross-attention (``cross_kv``);
    the self-attention cache is written in place."""
    h = L.apply_norm(x, params["norm1"], _NORM)
    attn, _ = L.attention_fwd(params["self_attn"], h,
                              _attn_cfg(cfg, causal=True),
                              positions=positions, kv_cache=kv_cache,
                              cache_index=cache_index)
    x = x + attn
    h = L.apply_norm(x, params["norm2"], _NORM)
    cross, _ = L.attention_fwd(params["cross_attn"], h,
                               _attn_cfg(cfg, causal=False),
                               positions=positions, kv_override=enc_kv)
    x = x + cross
    h = L.apply_norm(x, params["norm3"], _NORM)
    return x + L.mlp_fwd(params["mlp"], h, _mlp_cfg(cfg))


def cross_kv(params, cfg: ModelConfig, enc_states: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of one decoder layer from the encoder
    states: each (B, enc_seq, KV, hd)."""
    B, S, _ = enc_states.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    p = params["cross_attn"]
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
    reference computes them before its layer scan."""
    dtype = T.dtype_of(cfg.compute_dtype)
    S = tokens.shape[1]
    start = 0 if cache_index is None else cache_index
    positions = start + torch.arange(S, device=tokens.device)
    x = L.embed(params["embedding"], tokens).to(dtype)
    x = x + _sinusoidal(positions, cfg.d_model).to(dtype)[None]
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
    ({"frame_embeds", "tokens", "labels"} and an optional "mask")."""
    return T.lm_loss(forward, params, cfg, batch, remat)


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
