"""Mamba2 (SSD, state-space duality) blocks and LM (port of
``repro.models.mamba2``).

Prefill runs the SSD chunked scan through ``ops.ssd_scan`` (the Hopper
kernel on the card); decode is the O(1) one-token state recurrence
``ssd_decode_step`` and the streaming ``causal_conv1d``, both plain
PyTorch, as in the reference.

Parameters are ``{"embedding", "layers": [block dict per layer],
"final_norm"}``, the reference's stacked layer leaves unstacked into a
list.  They are cast to the compute dtype once, at load
(``transformer.cast_params``), every float leaf included: in bf16,
``A = -exp(A_log)`` is computed in bf16 and ``dt_bias`` is a bf16 bias
added to fp32, exactly as in the reference.  The cache is
``{"conv": (L, B, w-1, conv_ch), "ssd": (L, B, H, P, N)}``, updated in
place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_mat: torch.Tensor, C_mat: torch.Tensor, D: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x (B,S,H,P); dt (B,S,H) positive step sizes; A (H,)
    negative decay rates; B_mat/C_mat (B,S,G,N); D (H,) skip.  Returns
    (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32)."""
    return ops.ssd_scan(x, dt, A, B_mat, C_mat, D, chunk=chunk,
                        init_state=init_state)


def ssd_decode_step(x, dt, A, B_mat, C_mat, D, state):
    """One-token SSD update.  x (B,H,P); dt (B,H); B_mat/C_mat (B,G,N);
    state (B,H,P,N).  Returns (y in x's dtype, new state in state's
    dtype)."""
    H = x.shape[1]
    xf, dtf = x.float(), dt.float()
    Bh = B_mat.float().repeat_interleave(H // B_mat.shape[1], dim=1)
    Ch = C_mat.float().repeat_interleave(H // C_mat.shape[1], dim=1)
    decay = torch.exp(dtf * A.float())                          # (B,H)
    incr = (dtf[..., None] * xf)[..., None] * Bh[:, :, None, :]  # (B,H,P,N)
    new_state = decay[..., None, None] * state.float() + incr
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), new_state.to(state.dtype)


# ---------------------------------------------------------------------------
# causal depthwise conv1d (width w) with a streaming tail
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  prev: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,C); kernel (w,C); prev (B,w-1,C) streaming tail.  Returns
    (y (B,S,C) in x's dtype, new_tail (B,w-1,C)).  The tail is the
    concatenation's dtype: an fp32 cache tail beside bf16 x stays fp32,
    as ``jnp.concatenate`` promotes."""
    B, S, C = x.shape
    w = kernel.shape[0]
    if prev is None:
        prev = x.new_zeros((B, w - 1, C))
    dtype = torch.promote_types(prev.dtype, x.dtype)
    xp = torch.cat([prev.to(dtype), x.to(dtype)], dim=1)    # (B,S+w-1,C)
    kf = kernel.float()
    y = xp[:, 0:S].float() * kf[0]
    for j in range(1, w):
        y = y + xp[:, j:j + S].float() * kf[j]
    y = (y + bias.float()).to(x.dtype)
    return y, xp[:, S:]


# ---------------------------------------------------------------------------
# mamba2 block
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv_width
    conv_ch = di + 2 * G * N
    proj_out = 2 * di + 2 * G * N + H
    f32 = torch.float32
    return {
        "in_proj": L.fan_in_init(gen, (d, proj_out), dtype, device),
        "conv_kernel": L.normal_init(gen, (w, conv_ch), dtype, device,
                                     scale=0.5 / w),
        "conv_bias": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=device)),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "D": torch.ones((H,), dtype=f32, device=device),
        "norm": L.init_norm(di, "rmsnorm", dtype, device),
        "out_proj": L.fan_in_init(gen, (di, d), dtype, device),
        "in_norm": L.init_norm(d, cfg.norm_type, dtype, device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, GN = cfg.d_inner, cfg.ssm_n_groups * cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * GN],
            zxbcdt[..., 2 * di + 2 * GN:])


def _split_xbc(cfg: ModelConfig, xBC: torch.Tensor):
    di, GN = cfg.d_inner, cfg.ssm_n_groups * cfg.ssm_state
    return xBC[..., :di], xBC[..., di:di + GN], xBC[..., di + GN:]


def _gated_out(params, y: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """rmsnorm(y * silu(z)) @ out_proj, plus the residual."""
    y = L.rmsnorm(y * L.silu(z.float()).to(y.dtype),
                  params["norm"]["scale"], cfg.norm_eps)
    return u + y @ params["out_proj"]


def block_fwd(params, u: torch.Tensor, cfg: ModelConfig, *,
              conv_state: Optional[torch.Tensor] = None,
              ssd_state: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence mamba2 block.  u (B,S,d_model).  Returns (out, (new
    conv tail, final SSD state fp32))."""
    B, S, _ = u.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_n_groups, cfg.ssm_state
    h = L.apply_norm(u, params["in_norm"], cfg.norm_type)
    z, xBC, dt = _split_proj(cfg, h @ params["in_proj"])
    xBC, new_conv = causal_conv1d(xBC, params["conv_kernel"],
                                  params["conv_bias"], conv_state)
    x, B_mat, C_mat = _split_xbc(cfg, L.silu(xBC))
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final_state = ssd_chunked(
        x.reshape(B, S, H, P).contiguous(), dt.contiguous(), A,
        B_mat.reshape(B, S, G, N).contiguous(),
        C_mat.reshape(B, S, G, N).contiguous(), params["D"], cfg.ssm_chunk,
        init_state=ssd_state)
    out = _gated_out(params, y.reshape(B, S, cfg.d_inner), z, u, cfg)
    return out, (new_conv, final_state)


def block_decode(params, u: torch.Tensor, cfg: ModelConfig, *,
                 conv_state: torch.Tensor, ssd_state: torch.Tensor):
    """One-token mamba2 step.  u (B,1,d_model)."""
    B = u.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_n_groups, cfg.ssm_state
    h = L.apply_norm(u, params["in_norm"], cfg.norm_type)
    z, xBC, dt = _split_proj(cfg, h @ params["in_proj"])
    xBC, new_conv = causal_conv1d(xBC, params["conv_kernel"],
                                  params["conv_bias"], conv_state)
    x, B_mat, C_mat = _split_xbc(cfg, L.silu(xBC))
    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, new_state = ssd_decode_step(
        x[:, 0].reshape(B, H, P), dt1, A, B_mat[:, 0].reshape(B, G, N),
        C_mat[:, 0].reshape(B, G, N), params["D"], ssd_state)
    out = _gated_out(params, y.reshape(B, 1, cfg.d_inner), z, u, cfg)
    return out, (new_conv, new_state)


def apply_block(params, x: torch.Tensor, cfg: ModelConfig,
                conv: Optional[torch.Tensor], ssd: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """One mamba2 layer over a whole sequence (prefill) or one token
    (decode, when a cache is given and S == 1).  ``conv`` and ``ssd`` are
    the layer's cache slices, overwritten in place; the new SSD state is
    cast to the cache's dtype, as the reference's scan carry is."""
    if conv is None:
        return block_fwd(params, x, cfg)[0]
    step = block_decode if x.shape[1] == 1 else block_fwd
    x, (nc, ns) = step(params, x, cfg, conv_state=conv, ssd_state=ssd)
    conv.copy_(nc)
    ssd.copy_(ns)
    return x


# ---------------------------------------------------------------------------
# full mamba2 LM
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and scales, drawn
    from ``generator`` on ``device`` (use ``repro_torch.bridge`` where
    the reference's own draws are needed)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = T.dtype_of(cfg.param_dtype)
    return {
        "embedding": L.init_embedding(generator, cfg.padded_vocab,
                                      cfg.d_model, dtype, dev),
        "layers": [init_block(generator, cfg, dtype, dev)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.init_norm(cfg.d_model, cfg.norm_type, dtype, dev),
    }


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """``max_seq`` is unused: the recurrent state does not grow."""
    dev, dt = resolve_device(device), T.dtype_of(dtype)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv_width - 1,
                             conv_channels(cfg)), dtype=dt, device=dev),
        "ssd": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                            cfg.ssm_head_dim, cfg.ssm_state), dtype=dt,
                           device=dev),
    }


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_index: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (hidden_states, cache); the cache is updated in place.
    ``cache_index`` is accepted for the model API; the state needs none."""
    x = T._embed_inputs(params, cfg, batch)
    for i, layer in enumerate(params["layers"]):
        x = apply_block(layer, x, cfg,
                        None if cache is None else cache["conv"][i],
                        None if cache is None else cache["ssd"][i])
    return L.apply_norm(x, params["final_norm"], cfg.norm_type), cache


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt, filling the cache; logits of the last position."""
    hidden, cache = forward(params, cfg, batch, cache=cache, cache_index=0)
    return T.logits_fn(params, cfg, hidden[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: tokens (B, 1)."""
    hidden, cache = forward(params, cfg, {"tokens": tokens}, cache=cache,
                            cache_index=cache_index)
    return T.logits_fn(params, cfg, hidden), cache
