"""A plain emulation of the tensor-core flash backward's numerics
(``src/repro_torch/csrc/flash_attention_bwd_tc.cu``), for the tests.

It is not the kernel's plain version (autograd through
``repro_torch.kernels.ref.attention_ref``, fp32 throughout) but the
contract the kernel states: delta = rowsum(dO * O) in fp32 over the bf16
O and dO; S = Q K^T and dP = dO V^T as bf16 products summed in fp32;
P = exp(S * scale - lse) from the forward's fp32 log-sum-exp and
dS = P * (dP - delta) in fp32; P and dS rounded to bf16 (round to
nearest even) before dV = P^T dO, dK = dS^T Q and dQ = dS K, summed in
fp32 (dK and dV over the group's heads in the same fp32 sum); dQ and dK
times the softmax scale and every gradient rounded to bf16 once, at the
end.  A row with no visible key gets exact zero dq, a key no row sees
exact zero dk and dv.  It imports torch only, so the card tests and
``chip_smoke.py`` can use it on a machine without JAX.
"""

from typing import Optional

import torch

from _flash_emulation import flash_tc_emulation


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def flash_bwd_tc_emulation(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, dout: torch.Tensor, *,
                           causal: bool = True,
                           sliding_window: Optional[int] = None,
                           q_offset: int = 0,
                           kv_len: Optional[int] = None,
                           out: Optional[torch.Tensor] = None,
                           lse: Optional[torch.Tensor] = None):
    """Model layout: q, dout (B,Sq,H,D); k, v (B,Skv,HKV,D) -> (dq, dk,
    dv) in bf16.  ``out`` (B,Sq,H,D) and ``lse`` (B,H,Sq) are the
    forward's; by default the forward's emulation
    (``flash_tc_emulation``) and the fp32 log-sum-exp of the masked
    scaled scores (-inf for a row with no visible key)."""
    B, Sq, H, D = q.shape
    Skv, HKV = k.shape[1], k.shape[2]
    G = H // HKV
    scale = 1.0 / D ** 0.5
    qf, kf, vf, gf = (_bf16(t) for t in (q, k, v, dout))
    kg = kf.repeat_interleave(G, dim=2)
    vg = vf.repeat_interleave(G, dim=2)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = kpos < (Skv if kv_len is None else kv_len)
    if causal:
        mask = mask & (kpos <= qpos)
    if sliding_window is not None:
        mask = mask & (kpos > qpos - sliding_window)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kg) * scale
    if lse is None:
        lse = torch.logsumexp(
            torch.where(mask, s, torch.full_like(s, float("-inf"))), dim=-1)
    if out is None:
        out = flash_tc_emulation(q.to(torch.bfloat16), k, v, causal=causal,
                                 sliding_window=sliding_window,
                                 q_offset=q_offset, kv_len=kv_len)
    delta = (_bf16(out) * gf).sum(-1).permute(0, 2, 1)        # (B,H,Sq)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vg)
    ds = p * (dp - delta[..., None])
    pb, dsb = _bf16(p), _bf16(ds)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kg) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, gf)
    dk = dk.reshape(B, Skv, HKV, G, D).sum(3) * scale
    dv = dv.reshape(B, Skv, HKV, G, D).sum(3)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))
