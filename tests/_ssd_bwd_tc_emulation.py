"""An emulation of the tensor-core SSD-scan backward kernel's numerical
contract (``src/repro_torch/csrc/ssd_scan_bwd_tc.cu``), for the tests.

Not the kernel's plain version (autograd of ``repro_torch.kernels.ref.
ssd_chunked_ref``) but the kernel's algorithm, in its order, over chunks
of Qb = min(Q, 64) positions:

- launch 1 walks the chunk-boundary states forward and their gradients
  g backward, each increment (w o x)^T B or (exp(cum) o dy)^T C with the
  scaled bf16 operand split into bf16 hi + lo;
- launch 2, per (chunk, run of heads of one group, batch): the scores S
  = C B^T once, then per head, in head order, G = dy x^T, the masked
  M o S, M o G and exp(cum_q - cum_k) S G; dx = w o (B g'^T) + D dy +
  (M o S)^T dy; dcum from the row and column sums of T, x_j . (g' B_j),
  exp(cum_j) dy_j . (h C_j) and <g', h'> = exp(cl) <g', h> + sum_k w_k
  x_k . (g' B_k); dB and dC summed over the run's heads: each head's
  (w o x) g' and (exp(cum) o dy) h, then (sum over the run of M o G)^T C
  and (sum of M o G) B;
- launch 3 adds the runs of each group in order, dA and dD over (batch,
  chunk) in order.

Every product takes x, dy, B and C as the bf16 values they are; every
fp32 operand (g', h, M o S, the run's sum of M o G, w o x, exp(cum) o
dy) is split into bf16 hi + lo (``split_bf16``), both halves multiplied
and summed in fp32, and where both operands are fp32 the lo x lo product
is dropped; ``terms=1`` keeps hi alone, to show what the split buys.
dx, dB and dC are rounded to bf16 once, at the end.  It imports torch
only.
"""

from typing import List, Optional

import torch

from _ssd_emulation import split_bf16

BWD_CHUNK = 64


def _ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p
    return acc


def ssd_bwd_tc_emulation(x, dt, A, B_mat, C_mat, D, dy, *, chunk: int = 128,
                         init_state: Optional[torch.Tensor] = None,
                         dstate: Optional[torch.Tensor] = None,
                         run: int = 8, terms: int = 2):
    """Gradients of ``ssd_scan``'s (y, final state) against (dy, dstate)
    for bf16 x, B, C and dy: returns (dx, ddt, dA, dB, dC, dD, dh0); dx,
    dB, dC bf16, the rest fp32, dh0 None without an initial state.
    ``run`` is the number of consecutive heads of one group whose dB and
    dC one block sums (the last run of a group may be shorter)."""
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    HG = H // G
    Qb = min(chunk, S, BWD_CHUNK)
    nc = -(-S // Qb)
    f32 = dict(dtype=torch.float32, device=x.device)
    xf, dyf, dtf = x.float(), dy.float(), dt.float()
    Af, Df = A.float(), D.float()
    Bg, Cg = B_mat.float(), C_mat.float()                  # (B,S,G,N)
    grp = torch.arange(H, device=x.device) // HG
    Bh, Ch = Bg[:, :, grp], Cg[:, :, grp]                  # (B,S,H,N)

    def split(v):
        return split_bf16(v, terms)

    def both(eq, a, b):
        """einsum of two split fp32 operands: every pair of parts but
        lo x lo."""
        sa, sb = split(a), split(b)
        return sum(torch.einsum(eq, pa, pb) for i, pa in enumerate(sa)
                   for j, pb in enumerate(sb) if i + j < 2)

    def one(eq, a, b, split_first=True):
        """einsum with one split fp32 operand and one exact bf16 one."""
        if split_first:
            return sum(torch.einsum(eq, p, b) for p in split(a))
        return sum(torch.einsum(eq, a, p) for p in split(b))

    def chunk_of(c):
        sl = slice(c * Qb, min(S, (c + 1) * Qb))
        dtc = dtf[:, sl]
        return sl, dtc, torch.cumsum(dtc * Af, dim=1)     # (B,Qc,H)

    # launch 1: the state entering each chunk, and the gradient of the
    # state after each chunk
    h = (torch.zeros((Bsz, H, P, N), **f32) if init_state is None
         else init_state.float())
    states = []
    for c in range(nc):
        states.append(h)
        sl, dtc, cum = chunk_of(c)
        cl = cum[:, -1]
        w = dtc * torch.exp(cl[:, None] - cum)
        h = torch.exp(cl)[..., None, None] * h + one(
            "bkhp,bkhn->bhpn", w[..., None] * xf[:, sl], Bh[:, sl])
    g = (torch.zeros((Bsz, H, P, N), **f32) if dstate is None
         else dstate.float())
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        sl, dtc, cum = chunk_of(c)
        g = torch.exp(cum[:, -1])[..., None, None] * g + one(
            "bqhp,bqhn->bhpn", torch.exp(cum)[..., None] * dyf[:, sl],
            Ch[:, sl])

    # launch 2
    dx = torch.empty((Bsz, S, H, P), **f32)
    ddt = torch.empty((Bsz, S, H), **f32)
    runs = [(gi, h0, min(h0 + run, (gi + 1) * HG)) for gi in range(G)
            for h0 in range(gi * HG, (gi + 1) * HG, run)]
    pB = torch.empty((Bsz, S, len(runs), N), **f32)
    pC = torch.empty((Bsz, S, len(runs), N), **f32)
    pA = torch.empty((Bsz, nc, H), **f32)
    pD = torch.empty((Bsz, nc, H), **f32)
    for c in range(nc):
        sl, dtc, cum = chunk_of(c)
        Qc = dtc.shape[1]
        cl = cum[:, -1]
        xc, yc = xf[:, sl], dyf[:, sl]
        bh, ch = Bh[:, sl], Ch[:, sl]
        h_in, g_out = states[c], gs[c]
        s_ = torch.einsum("bqhn,bkhn->bqkh", ch, bh)
        g_ = torch.einsum("bqhp,bkhp->bqkh", yc, xc)
        mask = torch.ones((Qc, Qc), dtype=torch.bool,
                          device=x.device).tril()[None, :, :, None]
        diff = cum[:, :, None] - cum[:, None]              # (B,q,k,H)
        L = torch.exp(torch.where(mask, diff, torch.full_like(
            diff, -torch.inf)))
        md = L * dtc[:, None]
        ms, mg, lt = md * s_, md * g_, L * s_ * g_
        vrow = torch.einsum("bqkh,bkh->bqh", lt, dtc)
        vcol = lt.sum(1)                                   # (B,k,H)
        w = dtc * torch.exp(cl[:, None] - cum)
        v = one("bkhn,bhpn->bkhp", bh, g_out, split_first=False)
        vxv = (xc * v).sum(-1)                             # x_k . (g' B_k)
        dx[:, sl] = (w[..., None] * v + Df[None, None, :, None] * yc) \
            + one("bqkh,bqhp->bkhp", ms, yc)
        u = one("bqhn,bhpn->bqhp", ch, h_in, split_first=False)
        vcar = torch.exp(cum) * (yc * u).sum(-1)           # dy_q . (h C_q)
        gh = sum(split(g_out)) * sum(split(h_in))
        gh_next = torch.exp(cl) * gh.sum((-1, -2)) + (w * vxv).sum(1)
        dcum = vrow - dtc * vcol + vcar - w * vxv
        dcum[:, -1] += gh_next
        da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddt[:, sl] = Af * da + vcol + torch.exp(cl[:, None] - cum) * vxv
        pA[:, c] = (dtc * da).sum(1)
        pD[:, c] = (yc * xc).sum((1, 3))
        tB = both("bkhp,bhpn->bkhn", w[..., None] * xc, g_out)
        tC = both("bqhp,bhpn->bqhn", torch.exp(cum)[..., None] * yc, h_in)
        for r, (gi, a, b) in enumerate(runs):
            z = _ordered_sum([mg[..., hh] for hh in range(a, b)])
            pB[:, sl, r] = _ordered_sum(
                [tB[:, :, hh] for hh in range(a, b)]) + one(
                "bqk,bqn->bkn", z, Cg[:, sl, gi])
            pC[:, sl, r] = _ordered_sum(
                [tC[:, :, hh] for hh in range(a, b)]) + one(
                "bqk,bkn->bqn", z, Bg[:, sl, gi])

    # launch 3: the fixed-order sums
    dB = torch.empty((Bsz, S, G, N), **f32)
    dC = torch.empty((Bsz, S, G, N), **f32)
    for gi in range(G):
        mine = [r for r, run_ in enumerate(runs) if run_[0] == gi]
        dB[:, :, gi] = _ordered_sum([pB[:, :, r] for r in mine])
        dC[:, :, gi] = _ordered_sum([pC[:, :, r] for r in mine])
    dA = _ordered_sum(list(pA.reshape(Bsz * nc, H)))
    dD = _ordered_sum(list(pD.reshape(Bsz * nc, H)))
    dh0 = None if init_state is None else g
    return (dx.to(x.dtype), ddt, dA, dB.to(B_mat.dtype),
            dC.to(C_mat.dtype), dD, dh0)
