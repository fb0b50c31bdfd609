"""Plain PyTorch versions of every kernel (the allclose targets).

They mirror ``repro.kernels.ref``: the CPU path of each wrapper runs
them, and the card's checks hold each CUDA kernel against them on the
same inputs.  All arithmetic is fp32; outputs come back in q's (or x's)
dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  sliding_window: Optional[int] = None,
                  sm_scale: Optional[float] = None,
                  q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,HKV,Skv,D) -> (B,H,Sq,D), fp32 math.

    Query row ``i`` sits at absolute position ``q_offset + i``; keys at
    or past ``kv_len`` are masked.  A row with no visible key returns
    zeros, as the online-softmax kernel does."""
    B, H, Sq, D = q.shape
    HKV, Skv = k.shape[1], k.shape[2]
    group = H // HKV
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * sm_scale
    q_idx = (torch.arange(Sq, device=q.device) + q_offset)[:, None]
    k_idx = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx <= q_idx
    if sliding_window is not None:
        mask &= k_idx > (q_idx - sliding_window)
    if kv_len is not None:
        mask &= k_idx < kv_len
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv)
    out = torch.where(mask.any(dim=-1)[:, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        sm_scale: Optional[float] = None,
                        sliding_window: Optional[int] = None
                        ) -> torch.Tensor:
    """Dense-gather version of the paged decode-attention kernel.

    q: (B,H,D); k/v pages: (P,ps,KV,D); page_table: (B,PMAX) int32;
    lengths: (B,) int32 -> (B,H,D), fp32 math.  Rows with length 0
    return exact zeros (the kernel's idle-slot contract)."""
    B, H, D = q.shape
    P, ps, KV, _ = k_pages.shape
    PMAX = page_table.shape[1]
    G = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    table = page_table.long()
    k = k_pages[table].reshape(B, PMAX * ps, KV, D).float()  # logical order
    v = v_pages[table].reshape(B, PMAX * ps, KV, D).float()
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * sm_scale
    pos = torch.arange(PMAX * ps, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = pos < lens
    if sliding_window is not None:
        mask &= pos > (lens - 1 - sliding_window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, H, D).to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
