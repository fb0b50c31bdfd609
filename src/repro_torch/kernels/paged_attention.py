"""Paged decode attention: wrapper around ``csrc/paged_attention.cu``.

Replaces ``repro.kernels.paged_attention.paged_decode_attention``.
Kernel-native layouts, as in the reference:

  q            (B, H, D)        one query token per sequence
  k/v pages    (P, ps, KV, D)   the shared pool (pool row P-1 may be a
                                trash page; the kernel never reads
                                positions >= lengths[b])
  page_table   (B, PMAX) int32  logical -> physical page ids
  lengths      (B,) int32       valid KV tokens per sequence (0 for an
                                idle row: output is all-zeros)
  out          (B, H, D)        in q's dtype

q may be fp32 or bf16 independently of the pages (the engine decodes
bf16 queries against an fp32 pool); all math is fp32.  A CPU tensor
takes the plain version in ``ref``; a CUDA tensor launches the kernel or
raises.  Decode needs no gradient: a CUDA call that autograd would
differentiate raises rather than return a result cut off from the graph.

The kernel is split-KV: each row's logical tokens are cut into splits of
``SPLIT`` positions, one block per (KV head, row, split) writes its
partial softmax to an fp32 workspace, and a second kernel combines each
row's splits in order.  ``launches`` counts calls (one per call, though
a call launches both kernels).  A row's output depends only on its own
length, window and logical K/V: bitwise the same on any physical page
layout, with any table width and in any batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0        # calls that launched the kernels since the last reset
SOURCE = "src/repro_torch/csrc/paged_attention.cu"
REPLACES = "src/repro/kernels/paged_attention.py:140"
HEAD_DIMS = (64, 128)
SPLIT = 64          # logical tokens per split (csrc kSplit)


def _check(q, k_pages, v_pages, page_table, lengths, sliding_window):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (B,H,D) and pages (P,ps,KV,D), got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, D = q.shape
    P, ps, KV, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    if Dk != D or H % KV:
        raise ValueError(f"head dims {D}/{Dk} or heads {H}/{KV} mismatch")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError("page_table must be (B, PMAX) and lengths (B,)")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    devs = {t.device for t in (q, k_pages, v_pages, page_table, lengths)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           sm_scale: Optional[float] = None,
                           sliding_window: Optional[int] = None
                           ) -> torch.Tensor:
    """q (B,H,D); k/v pages (P,ps,KV,D); page_table (B,PMAX) int32;
    lengths (B,) int32 -> (B,H,D)."""
    global launches
    _check(q, k_pages, v_pages, page_table, lengths, sliding_window)
    B, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                       lengths, sm_scale=sm_scale,
                                       sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if _build.needs_grad(q, k_pages, v_pages):
        raise RuntimeError("paged decode attention has no backward kernel: "
                           "decode runs under torch.no_grad()")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged kernel inputs must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged kernel needs 16-byte aligned pages")
    out = torch.empty_like(q)
    P, ps, KV, _ = k_pages.shape
    PMAX = page_table.shape[1]
    if B == 0 or PMAX == 0:
        return out.zero_()
    n_splits = -(-PMAX * ps // SPLIT)
    ws_acc = torch.empty((B, H, n_splits, D), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32,
                        device=q.device)
    _build.launch("paged_attention_fwd", q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), page_table.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), ws_acc.data_ptr(),
                  ws_ml.data_ptr(), B, H, KV, D, ps, PMAX, float(sm_scale),
                  -1 if sliding_window is None else int(sliding_window),
                  _build.dtype_code(q), _build.dtype_code(k_pages))
    launches += 1
    return out
