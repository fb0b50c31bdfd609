"""Core neural layers on torch tensors (port of ``repro.models.layers``).

Parameters are plain dicts of tensors with the reference's names.  The
norms, the prefill attention and the paged decode attention go through
the kernel adapters in ``repro_torch.kernels.ops``; everything else is
eager PyTorch.  The ``*_axes`` functions give each parameter's logical
axes, the reference's names; the reference's activation annotations
(``constrain``) have no counterpart: under tensor parallelism the model
places explicit collectives instead (``repro_torch.sharding.tp``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import tp

# ---------------------------------------------------------------------------
# initializers (same shapes and scales as the reference; torch's generator
# draws other numbers than jax.random, so weights that must match the
# reference come through repro_torch.bridge instead)
# ---------------------------------------------------------------------------


def normal_init(gen, shape, dtype, device, scale: float = 0.02):
    return (scale * torch.randn(shape, generator=gen, device=device)
            ).to(dtype)


def fan_in_init(gen, shape, dtype, device):
    scale = 1.0 / math.sqrt(shape[0])
    return (scale * torch.randn(shape, generator=gen, device=device)
            ).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Row RMSNorm through the kernel (fp32 math, output in x's dtype)."""
    return ops.rmsnorm(x.contiguous(), scale, eps)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5
              ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def apply_norm(x: torch.Tensor, params: Dict[str, Any],
               kind: str) -> torch.Tensor:
    """kind in {rmsnorm, layernorm, nonparam_ln}.  The eps values are the
    reference's: 1e-6 for rmsnorm and 1e-5 for layernorm, whatever the
    config's ``norm_eps`` (which only qk-norm reads)."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    if kind == "nonparam_ln":  # OLMo: no affine parameters
        return layernorm(x, None, None)
    raise ValueError(kind)


def norm_axes(kind: str) -> Dict[str, Any]:
    if kind == "rmsnorm":
        return {"scale": ("embed_norm",)}
    if kind == "layernorm":
        return {"scale": ("embed_norm",), "bias": ("embed_norm",)}
    return {}


def init_norm(d: int, kind: str, dtype, device) -> Dict[str, Any]:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# rotary position embeddings (split-half, not interleaved)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (.., s, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # (.., s, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: int = 0,
                  sliding_window: Optional[int] = None,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention, the plain dense reference.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), Hq = G * Hkv.
    ``q_offset``: absolute position of q[0]; ``kv_len``: number of valid
    kv entries.  Returns (B, Sq, Hq, D).  The model's own prefill calls
    the flash kernel through ``ops.flash_attention`` instead.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    Skv = k.shape[1]
    kv_pos = torch.arange(Skv, device=q.device)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if sliding_window is not None:
        mask &= kv_pos[None, :] > (q_pos[:, None] - sliding_window)
    if kv_len is not None:
        mask &= kv_pos[None, :] < kv_len
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    causal: bool = True
    use_rope: bool = True
    norm_eps: float = 1e-6


def init_attention(gen, cfg: AttentionConfig, dtype,
                   device) -> Dict[str, Any]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": fan_in_init(gen, (d, H * hd), dtype, device),
        "wk": fan_in_init(gen, (d, KV * hd), dtype, device),
        "wv": fan_in_init(gen, (d, KV * hd), dtype, device),
        "wo": fan_in_init(gen, (H * hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def attention_axes(cfg: AttentionConfig) -> Dict[str, Any]:
    p = {
        "wq": ("embed", "qkv_out"),
        "wk": ("embed", "kv_out"),
        "wv": ("embed", "kv_out"),
        "wo": ("qkv_out", "embed"),
    }
    if cfg.qkv_bias:
        p.update({"bq": ("qkv_out",), "bk": ("kv_out",), "bv": ("kv_out",)})
    if cfg.qk_norm:
        p.update({"q_norm": ("head_dim",), "k_norm": ("head_dim",)})
    return p


def _project(params, x: torch.Tensor, cfg: AttentionConfig, name: str,
             heads: int, positions: torch.Tensor) -> torch.Tensor:
    """One of the q/k/v projections (+ optional bias), head reshape, and
    for q and k the optional qk-norm and RoPE at ``positions``."""
    B, S, _ = x.shape
    t = x @ params[f"w{name}"]
    if cfg.qkv_bias:
        t = t + params[f"b{name}"]
    t = t.reshape(B, S, heads, cfg.head_dim)
    if name == "v":
        return t
    if cfg.qk_norm:
        t = rmsnorm(t, params[f"{name}_norm"], cfg.norm_eps)
    if cfg.use_rope:
        t = apply_rope(t, positions, cfg.rope_theta)
    return t


def project_qkv(params, x: torch.Tensor, cfg: AttentionConfig, *,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared QKV prologue for the dense and paged attention paths:
    projections (+ optional bias), head reshape, optional qk-norm,
    RoPE at ``positions``.  q: (B,S,H,hd); k, v: (B,S,KV,hd)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return (_project(params, x, cfg, "q", H, positions),
            _project(params, x, cfg, "k", KV, positions),
            _project(params, x, cfg, "v", KV, positions))


def attention_fwd(params, x: torch.Tensor, cfg: AttentionConfig, *,
                  positions: torch.Tensor,
                  kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  cache_index: Optional[int] = None,
                  kv_override: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                  ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor,
                                                          torch.Tensor]]]:
    """Attention with an optional KV cache (decode) or KV override
    (cross-attention), through the flash kernel.

    x: (B, S, d).  kv_cache: (k, v) each (B, max_seq, KV, hd); the new
    keys are written into it IN PLACE at ``cache_index`` (the reference
    returns a functional copy; the contents are the same) and attention
    runs over the cache with ``kv_len = cache_index + S``.
    kv_override: (k, v) each (B, Skv, KV, hd), computed elsewhere; only
    q is projected, and every key is visible unless ``cfg.causal``.
    Returns (out, cache) (``None`` for the cache with an override).
    """
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    if kv_override is not None:
        q = _project(params, x, cfg, "q", H, positions)
        k, v = kv_override
        out = ops.flash_attention(q, k, v, causal=cfg.causal,
                                  sliding_window=cfg.sliding_window)
        return out.reshape(B, S, H * hd) @ params["wo"], None
    q, k, v = project_qkv(params, x, cfg, positions=positions)
    if kv_cache is not None:
        ck, cv = kv_cache
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
        k, v = ck, cv
        q_offset, kv_len = cache_index, cache_index + S
    else:
        q_offset, kv_len = 0, None
    out = ops.flash_attention(q, k, v, causal=cfg.causal,
                              sliding_window=cfg.sliding_window,
                              q_offset=q_offset, kv_len=kv_len)
    out = out.reshape(B, S, H * hd) @ params["wo"]
    return out, kv_cache


def attention_fwd_paged(params, x: torch.Tensor, cfg: AttentionConfig, *,
                        positions: torch.Tensor,
                        k_pages: torch.Tensor, v_pages: torch.Tensor,
                        page_table: torch.Tensor, lengths: torch.Tensor,
                        ) -> torch.Tensor:
    """Decode attention over a *paged* KV pool (one layer's pages).

    x: (B, 1, d) — one new token per sequence.  k/v pages: (P, ps, KV,
    hd), the shared physical page pool for this layer.  page_table:
    (B, PMAX) int32 logical->physical ids.  lengths: (B,) int32 current
    KV length per sequence — also the write position of this token
    (idle rows carry length 0 and a page table full of trash-page ids;
    their writes land in the trash page and their output is ignored).

    The new token's K/V is scattered into each row's current page IN
    PLACE (the reference's ``.at[].set`` copy gives the same contents),
    then the paged kernel gathers the whole prefix through the page
    table.  Rows that write one slot (idle rows, all at the trash page's
    first) write the last such row's K/V: every one of them then reads
    it, as the reference's scatter leaves it on the CPU, in the same
    bits on every launch (a scatter of duplicate indices leaves either
    on the card).  Returns out (B, 1, d).

    Under tensor parallelism ``cfg`` holds the rank's local heads
    (``tp.Plan.local_attention``), the projections are its columns and
    the pages hold its kv heads only: the scatter writes those heads,
    and the kernel reads them.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError("paged attention serves decode (one token/step)")
    H, hd = cfg.n_heads, cfg.head_dim
    ps = k_pages.shape[1]
    q, k, v = project_qkv(params, x, cfg, positions=positions)
    lens = lengths.long()
    rows = torch.arange(B, device=x.device)
    phys = page_table.long()[rows, lens // ps]
    off = lens % ps
    slot = phys * ps + off
    last = torch.where(slot[:, None] == slot[None, :], rows, -1).amax(1)
    k_pages.index_put_((phys, off), k[last, 0].to(k_pages.dtype))
    v_pages.index_put_((phys, off), v[last, 0].to(v_pages.dtype))
    out = ops.paged_attention(q, k_pages, v_pages, page_table, lengths + 1,
                              sliding_window=cfg.sliding_window)
    return out.reshape(B, S, H * hd) @ params["wo"]


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"   # silu (SwiGLU-gated) | gelu (plain)
    gated: bool = True


def init_mlp(gen, cfg: MLPConfig, dtype, device) -> Dict[str, Any]:
    p = {"w_up": fan_in_init(gen, (cfg.d_model, cfg.d_ff), dtype, device),
         "w_down": fan_in_init(gen, (cfg.d_ff, cfg.d_model), dtype, device)}
    if cfg.gated:
        p["w_gate"] = fan_in_init(gen, (cfg.d_model, cfg.d_ff), dtype,
                                  device)
    return p


def mlp_axes(cfg: MLPConfig) -> Dict[str, Any]:
    p = {"w_up": ("embed", "ff"), "w_down": ("ff", "embed")}
    if cfg.gated:
        p["w_gate"] = ("embed", "ff")
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x).  In a 16-bit dtype it is computed as the
    reference's ``jax.nn.silu`` lowers there: ``x * (1 / (1 + exp(-x)))``
    with every step rounded to x's dtype.  ``F.silu`` rounds once and
    lands one bf16 ulp away on about a third of the elements, a drift
    that compounds over the layers."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x * torch.reciprocal(1 + torch.exp(-x))
    return F.silu(x)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def mlp_fwd(params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    up = x @ params["w_up"]
    if cfg.gated:
        gate = x @ params["w_gate"]
        act = silu(gate) if cfg.activation == "silu" else _gelu(gate)
        h = act * up
    else:
        h = _gelu(up) if cfg.activation == "gelu" else silu(up)
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab: int, d: int, dtype, device):
    return {"table": normal_init(gen, (vocab, d), dtype, device)}


def embedding_axes():
    return {"table": ("vocab", "embed")}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table.  ``F.embedding``'s backward sums each row's
    gradients in a fixed order on the card (indexing's would add them
    with atomics): a training run repeats in bits."""
    return F.embedding(tokens, params["table"])


def unembed(params, x: torch.Tensor, vocab: Optional[int] = None,
            plan: Optional[tp.Plan] = None) -> torch.Tensor:
    """Logits over the padded table, sliced to ``vocab``: the padded rows
    are random, so an argmax must come after the slice.  Under a plan
    with a ``model`` axis over 1 the table is the rank's rows of the
    padded vocab and the logits are its columns, unsliced: the last
    rank's hold padded columns, which ``tp.vocab_parallel_argmax`` and
    ``tp.vocab_parallel_cross_entropy`` leave out."""
    if plan is not None and plan.model_n > 1:
        return tp.copy_to_model(x, plan) @ params["table"].t()
    logits = x @ params["table"].t()
    if vocab is not None and vocab != logits.shape[-1]:
        logits = logits[..., :vocab]
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in fp32.  logits: (B,S,V), labels:
    (B,S); an optional mask (B,S) weights the tokens."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
