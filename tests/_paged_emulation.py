"""A plain transcription of the split-KV paged decode kernel
(``src/repro_torch/csrc/paged_attention.cu``), for the tests.

Not the kernel's plain version (``repro_torch.kernels.ref.
paged_attention_ref``, one dense softmax per row) but its algorithm: a
row's logical tokens are cut into splits of ``SPLIT`` positions; each
live split (one that meets [first, len), ``first`` the window's start)
gathers its tokens through the page table and keeps (m, l, acc[D]) per
query head in fp32; the splits are combined in split order.  It imports
torch only, so the card tests can use it on a machine without JAX.
"""

from typing import Optional

import torch

SPLIT = 64
NEG_INF = -1e30


def live_splits(length: int, window: Optional[int], split: int = SPLIT,
                capacity: Optional[int] = None) -> range:
    """The splits of a row of ``length`` tokens that hold a live token:
    it depends on the row's own length, the window and the split size
    only (``capacity``, the table's PMAX * ps, clamps the length as the
    kernel does)."""
    if capacity is not None:
        length = min(length, capacity)
    first = 0 if window is None else max(0, length - window)
    if length <= first:
        return range(0)
    return range(first // split, (length - 1) // split + 1)


def paged_split_emulation(q, k_pages, v_pages, page_table, lengths, *,
                          sm_scale: Optional[float] = None,
                          sliding_window: Optional[int] = None,
                          split: int = SPLIT) -> torch.Tensor:
    """q (B,H,D); k/v pages (P,ps,KV,D); page_table (B,PMAX) int32;
    lengths (B,) int32 -> (B,H,D) in q's dtype."""
    B, H, D = q.shape
    _, ps, KV, _ = k_pages.shape
    PMAX = page_table.shape[1]
    G = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    dev = q.device
    out = torch.zeros((B, H, D), dtype=torch.float32, device=dev)
    for b in range(B):
        n = min(int(lengths[b]), PMAX * ps)
        first = 0 if sliding_window is None else max(0, n - sliding_window)
        qb = q[b].float().reshape(KV, G, D)
        parts = []                                    # (m, l, acc) per split
        for s in live_splits(n, sliding_window, split, PMAX * ps):
            pos = torch.arange(max(first, s * split), min(n, (s + 1) * split),
                               device=dev)
            phys = page_table[b].long()[pos // ps]
            k = k_pages[phys, pos % ps].float()           # (T, KV, D)
            v = v_pages[phys, pos % ps].float()
            sc = torch.einsum("hgd,thd->hgt", qb, k) * sm_scale
            m = sc.amax(dim=-1)                           # (KV, G)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(dim=-1),
                          torch.einsum("hgt,thd->hgd", p, v)))
        if not parts:
            continue                                      # exact zeros
        M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        o = torch.zeros((KV, G, D), device=dev)
        l = torch.zeros((KV, G), device=dev)
        for m, ls, acc in parts:                          # split order
            w = torch.exp(m - M)
            l = l + w * ls
            o = o + w[..., None] * acc
        out[b] = (o / l.clamp_min(1e-30)[..., None]).reshape(H, D)
    return out.to(q.dtype)
