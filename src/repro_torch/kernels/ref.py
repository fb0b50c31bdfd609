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


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(..., G, N) group projections -> (..., H, N): head h reads group
    h // (H / G)."""
    return t.repeat_interleave(H // t.shape[-2], dim=-2)


def ssd_ref(x, dt, A, B_mat, C_mat, D, *, init_state=None):
    """Sequential (token-by-token) SSD recurrence, the ground truth.

    x: (B,S,H,P); dt: (B,S,H); A, D: (H,); B_mat/C_mat: (B,S,G,N);
    init_state: (B,H,P,N) or None.  Returns (y (B,S,H,P) in x's dtype,
    final_state (B,H,P,N) fp32)."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    Af, Df = A.float(), D.float()
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].float(), dt[:, t].float()       # (B,H,P), (B,H)
        Bt = _heads(B_mat[:, t].float(), H)               # (B,H,N)
        Ct = _heads(C_mat[:, t].float(), H)
        decay = torch.exp(dtt * Af)
        incr = (dtt[..., None] * xt)[..., None] * Bt[:, :, None, :]
        state = decay[..., None, None] * state + incr
        y = torch.einsum("bhpn,bhn->bhp", state, Ct)
        ys.append(y + Df[None, :, None] * xt)
    y = torch.stack(ys, dim=1) if ys else x.float()
    return y.to(x.dtype), state


def ssd_chunked_ref(x, dt, A, B_mat, C_mat, D, chunk: int = 128, *,
                    init_state=None):
    """Chunked SSD scan, the function ``repro.models.mamba2.ssd_chunked``
    computes, with the inter-chunk state carried by a plain loop over
    chunks (the reference's associative scan sums in another order).

    Q = min(chunk, S); a ragged tail chunk is zero-padded, which is exact
    because dt = 0 adds nothing to the state or the outputs.  Per chunk:
    the masked intra-chunk term exp(cum_q - cum_k)·(C_q·B_k)·dt_k·x_k for
    k <= q (the mask inside the exponent, so nothing above the diagonal
    overflows), the carried-state term exp(cum_q)·C_q·h, the skip D·x,
    then h <- exp(sum a)·h + sum_k exp(cum_last - cum_k)·dt_k·x_k B_kᵀ.
    Shapes as ``ssd_ref``."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    f32 = torch.float32
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q

    def chunks(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], dim=1)
        return t.reshape((Bsz, nc, Q) + t.shape[2:])

    xc, dtc = chunks(x), chunks(dt)                       # (B,nc,Q,H,P)
    Bh, Ch = _heads(chunks(B_mat), H), _heads(chunks(C_mat), H)
    a = dtc * A.float()                                   # (B,nc,Q,H)
    cum = torch.cumsum(a, dim=2)
    dtx = xc * dtc[..., None]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        cq = cum[:, c]                                    # (B,Q,H)
        diff = cq[:, :, None, :] - cq[:, None, :, :]      # (B,Q,K,H)
        decay = torch.exp(torch.where(mask[None, :, :, None], diff,
                                      torch.full_like(diff, -torch.inf)))
        scores = torch.einsum("bqhn,bkhn->bqkh", Ch[:, c], Bh[:, c])
        y = torch.einsum("bqkh,bkhp->bqhp", scores * decay, dtx[:, c])
        y = y + torch.einsum("bqhn,bhpn->bqhp", Ch[:, c], state) \
            * torch.exp(cq)[..., None]
        ys.append(y)
        w = torch.exp(cq[:, -1:] - cq)                    # (B,Q,H)
        incr = torch.einsum("bkhp,bkhn->bhpn", dtx[:, c] * w[..., None],
                            Bh[:, c])
        state = torch.exp(a[:, c].sum(dim=1))[..., None, None] * state + incr
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * Q, H, P)[:, :S]
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state
