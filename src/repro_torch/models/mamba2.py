"""Mamba2 (SSD, state-space duality) blocks and LM (port of
``repro.models.mamba2``).

Prefill runs the SSD chunked scan through ``ops.ssd_scan`` (the Hopper
kernel on the card); decode is the O(1) one-token state recurrence
``ssd_decode_step`` and the streaming ``causal_conv1d``, both plain
PyTorch, as in the reference.

Parameters are ``{"embedding", "layers": [block dict per layer],
"final_norm"}``, the reference's stacked layer leaves unstacked into a
list.  For serving they are cast to the compute dtype once, at load
(``transformer.cast_params``), every float leaf included: in bf16,
``A = -exp(A_log)`` is computed in bf16 and ``dt_bias`` is a bf16 bias
added to fp32, exactly as in the reference.  ``loss_fn`` takes the fp32
masters and casts them inside the graph, so the gradients reach them;
with ``remat`` each layer is recomputed in the backward pass, as the
reference's ``jax.checkpoint`` of its layer body.  The cache is
``{"conv": (L, B, w-1, conv_ch), "ssd": (L, B, H, P, N)}``, updated in
place.

Under a tensor-parallel / FSDP plan (``repro_torch.sharding.tp``: the
training step's rules on a rank grid, or the fixed-batch session's on a
lease's grid) the parameters are this rank's blocks (``param_axes``,
the reference's names): ``in_proj``'s columns (``ssm_inner_proj``) and
the conv weights' channels (``ssm_conv_ch``) in contiguous blocks over
``model`` that are not head-aligned, ``A_log``, ``dt_bias`` and ``D``
the rank's heads (``ssm_heads``), ``out_proj``'s rows (``ssm_inner``,
head-aligned) and FSDP's ``embed`` over ``data`` (gathered at the top
of the block, again in a remat recompute).  A layer computes its block
of ``h @ in_proj`` and all-gathers it over ``model`` together with the
conv weights, in one collective (``tp.gather_model``, tag ``ssm``;
backward, their gradients' reduce-scatter), then takes its heads' z, x
and dt and all of B and C (G groups, each whole on every rank), runs
the conv on its heads' x channels and B and C, and the SSD scan on its
heads (B4, B8 backward: a rank's dB and dC are partial sums over its
heads, which the reduce-scatter adds).  The gated RMSNorm normalises
over the whole ``d_inner``: under ``model`` it runs as plain PyTorch
ops, the rank's fp32 sum of squares summed over ``model``
(``tp.sum_over_model``, tag ``ssm-norm``), so B2 does not run there; its
scale is whole on every rank, read on the rank's slice behind
``copy_to_model`` (its gradient summed over ``model``).  ``out_proj`` is
row-parallel, its output summed by ``reduce_from_model`` (tag ``ssm``).
A decode step takes three collectives a layer over ``model``: the
gather, the norm's sum and the output's sum.  The cache holds the
rank's rows, heads and conv channels (``init_cache``).
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
from repro_torch.sharding import tp


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


def block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of ``init_block``'s leaves (the reference's)."""
    return {
        "in_proj": ("embed", "ssm_inner_proj"),
        "conv_kernel": (None, "ssm_conv_ch"),
        "conv_bias": ("ssm_conv_ch",),
        "A_log": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "D": ("ssm_heads",),
        "norm": {"scale": ("ssm_inner_norm",)},
        "out_proj": ("ssm_inner", "embed"),
        "in_norm": L.norm_axes(cfg.norm_type),
    }


def _sharded(plan) -> bool:
    return plan is not None and plan.model_n > 1


def _rank_proj(params, h: torch.Tensor, cfg: ModelConfig, plan):
    """Under ``model``: the rank's block of ``h @ in_proj`` gathered with
    the conv weights' blocks (one collective), then the rank's heads' z,
    its heads' x with all of B and C (``xBC``), its heads' dt, and the
    conv weights of those channels."""
    di, GN = cfg.d_inner, cfg.ssm_n_groups * cfg.ssm_state
    m, r = plan.model_n, plan.model_index
    mine = slice(r * di // m, (r + 1) * di // m)
    hl = cfg.ssm_heads // m
    local = tp.copy_to_model(h, plan, what="ssm") @ params["in_proj"]
    full, kernel, bias = tp.gather_model(
        (local, params["conv_kernel"], params["conv_bias"]),
        (local.dim() - 1, 1, 0), plan, what="ssm")
    xBC = torch.cat([full[..., di:][..., mine],
                     full[..., 2 * di:2 * di + 2 * GN]], dim=-1)
    dt0 = 2 * di + 2 * GN + r * hl
    return (full[..., mine], xBC, full[..., dt0:dt0 + hl],
            torch.cat([kernel[:, mine], kernel[:, di:]], dim=1),
            torch.cat([bias[mine], bias[di:]]))


def _inner(params, u: torch.Tensor, cfg: ModelConfig, plan,
           conv_state: Optional[torch.Tensor]):
    """in_norm, in_proj, the causal conv and silu: (z, x, B_mat, C_mat,
    dt, the new conv tail), the rank's heads' under ``model``."""
    di, GN = cfg.d_inner, cfg.ssm_n_groups * cfg.ssm_state
    h = L.apply_norm(u, params["in_norm"], cfg.norm_type)
    if _sharded(plan):
        z, xBC, dt, kernel, bias = _rank_proj(params, h, cfg, plan)
    else:
        zxbcdt = h @ params["in_proj"]
        z, xBC, dt = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * GN],
                      zxbcdt[..., 2 * di + 2 * GN:])
        kernel, bias = params["conv_kernel"], params["conv_bias"]
    xBC, new_conv = causal_conv1d(xBC, kernel, bias, conv_state)
    xBC = L.silu(xBC)
    x = xBC[..., :xBC.shape[-1] - 2 * GN]
    return (z, x, xBC[..., x.shape[-1]:x.shape[-1] + GN],
            xBC[..., x.shape[-1] + GN:], dt, new_conv)


def _rank_norm(v: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig,
               plan) -> torch.Tensor:
    """The gated RMSNorm over the whole ``d_inner`` of which ``v`` holds
    the rank's heads' block, in plain ops (B2 normalises whole rows
    only): the fp32 sum of squares summed over ``model``, the scale's
    slice read behind ``copy_to_model``."""
    r, dl = plan.model_index, v.shape[-1]
    vf = v.float()
    ss = tp.sum_over_model(vf.square().sum(dim=-1, keepdim=True), plan,
                           what="ssm-norm")
    s = tp.copy_to_model(scale, plan, what="ssm-norm")[r * dl:(r + 1) * dl]
    return (vf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
            * s.float()).to(v.dtype)


def _gated_out(params, y: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
               cfg: ModelConfig, plan) -> torch.Tensor:
    """rmsnorm(y * silu(z)) @ out_proj, plus the residual; row-parallel
    under ``model``."""
    v = y * L.silu(z.float()).to(y.dtype)
    if not _sharded(plan):
        return u + L.rmsnorm(v, params["norm"]["scale"],
                             cfg.norm_eps) @ params["out_proj"]
    out = _rank_norm(v, params["norm"]["scale"], cfg, plan) \
        @ params["out_proj"]
    return u + tp.reduce_from_model(out, plan, what="ssm")


def _plan_params(params, cfg: ModelConfig):
    """(plan, the layer's parameters as the rank uses them: FSDP's
    gathered)."""
    plan = tp.plan()
    if plan is not None:
        params = tp.gather_params(params, block_axes(cfg), plan,
                                  T.dtype_of(cfg.compute_dtype))
    return plan, params


def block_fwd(params, u: torch.Tensor, cfg: ModelConfig, *,
              conv_state: Optional[torch.Tensor] = None,
              ssd_state: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence mamba2 block.  u (B,S,d_model).  Returns (out, (new
    conv tail, final SSD state fp32)); under a plan on the rank's heads
    (the module's docstring)."""
    B, S, _ = u.shape
    P, G, N = cfg.ssm_head_dim, cfg.ssm_n_groups, cfg.ssm_state
    plan, params = _plan_params(params, cfg)
    z, x, B_mat, C_mat, dt, new_conv = _inner(params, u, cfg, plan,
                                              conv_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final_state = ssd_chunked(
        x.reshape(B, S, -1, P).contiguous(), dt.contiguous(), A,
        B_mat.reshape(B, S, G, N).contiguous(),
        C_mat.reshape(B, S, G, N).contiguous(), params["D"], cfg.ssm_chunk,
        init_state=ssd_state)
    out = _gated_out(params, y.reshape(B, S, x.shape[-1]), z, u, cfg, plan)
    return out, (new_conv, final_state)


def block_decode(params, u: torch.Tensor, cfg: ModelConfig, *,
                 conv_state: torch.Tensor, ssd_state: torch.Tensor):
    """One-token mamba2 step.  u (B,1,d_model)."""
    B = u.shape[0]
    P, G, N = cfg.ssm_head_dim, cfg.ssm_n_groups, cfg.ssm_state
    plan, params = _plan_params(params, cfg)
    z, x, B_mat, C_mat, dt, new_conv = _inner(params, u, cfg, plan,
                                              conv_state)
    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, new_state = ssd_decode_step(
        x[:, 0].reshape(B, -1, P), dt1, A, B_mat[:, 0].reshape(B, G, N),
        C_mat[:, 0].reshape(B, G, N), params["D"], ssd_state)
    out = _gated_out(params, y.reshape(B, 1, x.shape[-1]), z, u, cfg, plan)
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


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of ``init_params``' tree, leaf for leaf (the
    reference's names; ``layers`` is the port's list, with no leading
    ``("layers",)`` axis)."""
    return {
        "embedding": L.embedding_axes(),
        "layers": [block_axes(cfg) for _ in range(cfg.n_layers)],
        "final_norm": L.norm_axes(cfg.norm_type),
    }


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state


def local_state(cfg: ModelConfig) -> Tuple[Tuple[int, int], Tuple[int, ...]]:
    """The per-row shapes of a layer's conv tail (w-1, channels) and SSD
    state (heads, P, N) under the plan in force: under ``model`` the
    rank's heads, its heads' x channels and all of B and C."""
    plan = tp.plan()
    m = plan.model_n if _sharded(plan) else 1
    ch = cfg.d_inner // m + 2 * cfg.ssm_n_groups * cfg.ssm_state
    return ((cfg.ssm_conv_width - 1, ch),
            (cfg.ssm_heads // m, cfg.ssm_head_dim, cfg.ssm_state))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """``max_seq`` is unused: the recurrent state does not grow.  Under a
    plan the rank's heads and conv channels (``local_state``)."""
    dev, dt = resolve_device(device), T.dtype_of(dtype)
    conv, ssd = local_state(cfg)
    return {
        "conv": torch.zeros((cfg.n_layers, batch) + conv, dtype=dt,
                            device=dev),
        "ssd": torch.zeros((cfg.n_layers, batch) + ssd, dtype=dt,
                           device=dev),
    }


def cache_axes() -> Dict[str, Any]:
    """The logical axes of ``init_cache``'s leaves, the reference's.  The
    ``ssd`` state under ``model`` is the rank's ``ssm_heads`` block; the
    ``conv`` tail is not the reference's contiguous ``ssm_conv_ch``
    block but the rank's heads' x channels and all of B and C
    (``local_state``): no cache crosses a process or a checkpoint, so
    nothing reads it by these axes."""
    return {"conv": ("layers", "batch", None, "ssm_conv_ch"),
            "ssd": ("layers", "batch", "ssm_heads", None, None)}


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_index: Optional[int] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (hidden_states, cache); the cache is updated in place.
    ``cache_index`` is accepted for the model API; the state needs none.
    ``remat`` (no cache) recomputes each layer in the backward pass."""
    x = T._embed_inputs(params, cfg, batch)
    for i, layer in enumerate(params["layers"]):
        if remat and cache is None:
            x = T.remat(lambda h, layer=layer: block_fwd(layer, h, cfg)[0],
                        x)
            continue
        x = apply_block(layer, x, cfg,
                        None if cache is None else cache["conv"][i],
                        None if cache is None else cache["ssd"][i])
    return L.apply_norm(x, params["final_norm"], cfg.norm_type), cache


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = True) -> torch.Tensor:
    """``transformer.lm_loss`` through this family's ``forward``
    (vocab-parallel under a plan)."""
    return T.lm_loss(forward, params, cfg, batch, remat,
                     axes_fn=param_axes)


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
