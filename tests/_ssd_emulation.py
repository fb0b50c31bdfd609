"""A plain emulation of the tensor-core SSD kernel's numerics
(``src/repro_torch/csrc/ssd_scan_tc.cu``), for the tests.

Not the kernel's plain version (``repro_torch.kernels.ref.
ssd_chunked_ref``, fp32 throughout) but the contract the kernel states,
in its order of products per chunk: x, B and C enter the products as
the bf16 values they are; every fp32 operand of a product -- the
weighted score matrix, the carried state h and s_k x (s_k = dt_k
exp(cum_last - cum_k)) -- is split into bf16 ``hi + lo`` and both halves
are multiplied and summed in fp32 (``terms=1`` keeps ``hi`` only, to
show what the split buys); cum, the decays and the mask are fp32, the
mask applied before the exponent.  y = (exp(cum_q) C.h^T + y_diag) + D x
in x's dtype; the state in fp32.  It imports torch only.
"""

from typing import List, Optional

import torch

bf16 = torch.bfloat16


def split_bf16(v: torch.Tensor, terms: int = 2) -> List[torch.Tensor]:
    """fp32 ``v`` as ``terms`` bf16 values (as fp32) that sum to it:
    hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.to(bf16).float()
    return [hi] if terms == 1 else [hi, (v - hi).to(bf16).float()]


def ssd_tc_emulation(x, dt, A, B_mat, C_mat, D, chunk: int = 128, *,
                     init_state: Optional[torch.Tensor] = None,
                     terms: int = 2):
    """x (B,S,H,P) bf16; dt (B,S,H); A, D (H,); B/C (B,S,G,N) bf16;
    init_state (B,H,P,N) or None -> (y (B,S,H,P) in x's dtype, state
    (B,H,P,N) fp32)."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    rep = H // B_mat.shape[2]
    Q = min(chunk, S)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = B_mat.float().repeat_interleave(rep, dim=2)      # (B,S,H,N)
    Ch = C_mat.float().repeat_interleave(rep, dim=2)
    state = (torch.zeros((Bsz, H, P, N), device=x.device)
             if init_state is None
             else init_state.float().clone())
    ys = []
    for t0 in range(0, S, Q):
        xc, dtc = xf[:, t0:t0 + Q], dtf[:, t0:t0 + Q]
        Bc, Cc = Bh[:, t0:t0 + Q], Ch[:, t0:t0 + Q]
        Qc = xc.shape[1]
        cum = torch.cumsum(dtc * Af, dim=1)               # (B,Qc,H)
        cum_last = cum[:, -1]                             # (B,H)
        # product 3, scaled by exp(cum_q): the accumulator y_diag adds to
        y = sum(torch.einsum("bqhn,bhpn->bqhp", Cc, h)
                for h in split_bf16(state, terms))
        y = y * torch.exp(cum)[..., None]
        # products 1 and 2: scores, weighted below the diagonal
        scores = torch.einsum("bqhn,bkhn->bqkh", Cc, Bc)
        mask = torch.ones((Qc, Qc), dtype=torch.bool,
                          device=x.device).tril()[None, :, :, None]
        diff = cum[:, :, None] - cum[:, None]             # (B,Q,K,H)
        w = torch.where(mask, scores * torch.exp(
            torch.where(mask, diff, torch.zeros_like(diff)))
            * dtc[:, None], torch.zeros_like(scores))
        y = y + sum(torch.einsum("bqkh,bkhp->bqhp", part, xc)
                    for part in split_bf16(w, terms))
        # product 4: the state increment, s_k folded into x
        sx = xc * (dtc * torch.exp(cum_last[:, None] - cum))[..., None]
        incr = sum(torch.einsum("bkhp,bkhn->bhpn", part, Bc)
                   for part in split_bf16(sx, terms))
        state = state * torch.exp(cum_last)[..., None, None] + incr
        ys.append(y + D.float()[None, None, :, None] * xc)
    return torch.cat(ys, dim=1).to(x.dtype), state
