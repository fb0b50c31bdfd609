"""A plain emulation of the tensor-core flash kernel's numerics
(``src/repro_torch/csrc/flash_attention_tc.cu``), for the tests.

It is not the kernel's plain version (``repro_torch.kernels.ref.
attention_ref``, fp32 throughout) but the contract the kernel states:
K and V rounded to bf16, q K^T and P V as bf16 products summed in fp32,
fp32 softmax statistics, P rounded to bf16 before P V, the row sum over
the fp32 probabilities, the output in q's dtype, zeros for a row with no
visible key.  It imports torch only, so the card tests can use it on a
machine without JAX.
"""

from typing import Optional

import torch


def flash_tc_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True,
                       sliding_window: Optional[int] = None,
                       q_offset: int = 0,
                       kv_len: Optional[int] = None) -> torch.Tensor:
    """Model layout: q (B,Sq,H,D); k, v (B,Skv,HKV,D) -> (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    Skv, HKV = k.shape[1], k.shape[2]
    G = H // HKV
    kb = k.to(torch.bfloat16).float().repeat_interleave(G, dim=2)
    vb = v.to(torch.bfloat16).float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb) / D ** 0.5
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = kpos < (Skv if kv_len is None else kv_len)
    if causal:
        mask = mask & (kpos <= qpos)
    if sliding_window is not None:
        mask = mask & (kpos > qpos - sliding_window)
    s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                 # masked: exp(-inf) = 0 exactly
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vb)
    l = l.permute(0, 2, 1, 3)            # (B,Sq,H,1)
    o = torch.where(l > 0, o / l.clamp_min(1e-30), torch.zeros_like(o))
    return o.to(q.dtype)
