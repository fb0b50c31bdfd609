"""A step-by-step emulation of the SSD-scan backward kernel
(``src/repro_torch/csrc/ssd_scan_bwd.cu``), for the tests.

Not the kernel's plain version (autograd of ``repro_torch.kernels.ref.
ssd_chunked_ref``) but the kernel's algorithm, in its order: chunks of
Qb = min(Q, 64) positions; the states entering each chunk walked
forward and their gradients g walked backward (launch 1); per chunk the
masked products M o S, M o G and exp(cum_q - cum_k) S G, dx, this
head's part of dB and dC, and dcum with its reverse running sum (launch
2); then dB and dC summed over each group's heads in head order and dA,
dD over (batch, chunk) in order (launch 3).  Everything is fp32 from
the inputs' values; only dx, dB and dC are rounded to the inputs' dtype,
once, at the end, as the kernel stores them.  It imports torch only.
"""

from typing import Optional

import torch

BWD_CHUNK = 64


def _ordered_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one slice at a time, in index order."""
    acc = t.select(dim, 0).clone()
    for i in range(1, t.shape[dim]):
        acc = acc + t.select(dim, i)
    return acc


def ssd_bwd_emulation(x, dt, A, B_mat, C_mat, D, dy, *, chunk: int = 128,
                      init_state: Optional[torch.Tensor] = None,
                      dstate: Optional[torch.Tensor] = None):
    """Gradients of ``ssd_scan``'s (y, final state) against (dy,
    dstate): returns (dx, ddt, dA, dB, dC, dD, dh0); dx, dB, dC in their
    inputs' dtypes, the rest fp32, dh0 None without an initial state."""
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    Qb = min(chunk, S, BWD_CHUNK)
    nc = -(-S // Qb)
    f32 = dict(dtype=torch.float32, device=x.device)
    xf, dyf, dtf = x.float(), dy.float(), dt.float()
    Af, Df = A.float(), D.float()
    Bh = B_mat.float().repeat_interleave(rep, dim=2)       # (B,S,H,N)
    Ch = C_mat.float().repeat_interleave(rep, dim=2)

    def chunk_of(c):
        sl = slice(c * Qb, min(S, (c + 1) * Qb))
        dtc = dtf[:, sl]
        return sl, dtc, torch.cumsum(dtc * Af, dim=1)     # (B,Qc,H)

    # launch 1: the state entering each chunk (and the final one), then
    # the gradient g of the state at each chunk boundary
    h = (torch.zeros((Bsz, H, P, N), **f32) if init_state is None
         else init_state.float())
    states = [h]
    for c in range(nc):
        sl, dtc, cum = chunk_of(c)
        cl = cum[:, -1]
        w = dtc * torch.exp(cl[:, None] - cum)
        h = torch.exp(cl)[..., None, None] * h + torch.einsum(
            "bkhp,bkhn->bhpn", w[..., None] * xf[:, sl], Bh[:, sl])
        states.append(h)
    g = (torch.zeros((Bsz, H, P, N), **f32) if dstate is None
         else dstate.float())
    gs = [None] * nc + [g]
    for c in reversed(range(nc)):
        sl, dtc, cum = chunk_of(c)
        g = torch.exp(cum[:, -1])[..., None, None] * g + torch.einsum(
            "bqhp,bqhn->bhpn", torch.exp(cum)[..., None] * dyf[:, sl],
            Ch[:, sl])
        gs[c] = g

    # launch 2: every term of each chunk
    dx = torch.empty((Bsz, S, H, P), **f32)
    ddt = torch.empty((Bsz, S, H), **f32)
    pB = torch.empty((Bsz, S, H, N), **f32)
    pC = torch.empty((Bsz, S, H, N), **f32)
    pA = torch.empty((Bsz, nc, H), **f32)
    pD = torch.empty((Bsz, nc, H), **f32)
    for c in range(nc):
        sl, dtc, cum = chunk_of(c)
        Qc = dtc.shape[1]
        cl = cum[:, -1]
        xc, yc, bc, cc = xf[:, sl], dyf[:, sl], Bh[:, sl], Ch[:, sl]
        h_in, g_out, h_out = states[c], gs[c + 1], states[c + 1]
        s_ = torch.einsum("bqhn,bkhn->bqkh", cc, bc)
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
        v = torch.einsum("bkhn,bhpn->bkhp", bc, g_out)     # g' B_k
        vxv = (xc * v).sum(-1)
        dx[:, sl] = (w[..., None] * v + Df[None, None, :, None] * yc) \
            + torch.einsum("bqkh,bqhp->bkhp", ms, yc)
        pB[:, sl] = w[..., None] * torch.einsum(
            "bkhp,bhpn->bkhn", xc, g_out) + torch.einsum(
            "bqkh,bqhn->bkhn", mg, cc)
        pC[:, sl] = torch.exp(cum)[..., None] * torch.einsum(
            "bqhp,bhpn->bqhn", yc, h_in) + torch.einsum(
            "bqkh,bkhn->bqhn", mg, bc)
        u = torch.einsum("bqhn,bhpn->bqhp", cc, h_in)      # h C_q
        vcar = torch.exp(cum) * (yc * u).sum(-1)
        dcum = vrow - dtc * vcol + vcar - w * vxv
        dcum[:, -1] += (g_out * h_out).sum((-1, -2))
        da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddt[:, sl] = Af * da + vcol + torch.exp(cl[:, None] - cum) * vxv
        pA[:, c] = _ordered_sum(torch.flip(dtc * da, [1]), 1)
        pD[:, c] = _ordered_sum((yc * xc).sum(-1), 1)

    # launch 3: the fixed-order sums
    dB = _ordered_sum(pB.reshape(Bsz, S, G, rep, N), 3)
    dC = _ordered_sum(pC.reshape(Bsz, S, G, rep, N), 3)
    dA = _ordered_sum(pA.reshape(Bsz * nc, H), 0)
    dD = _ordered_sum(pD.reshape(Bsz * nc, H), 0)
    dh0 = None if init_state is None else gs[0]
    return (dx.to(x.dtype), ddt, dA, dB.to(B_mat.dtype),
            dC.to(C_mat.dtype), dD, dh0)
