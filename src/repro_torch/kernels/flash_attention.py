"""Blocked (flash) attention for prefill: wrapper around two kernels,
chosen by q's dtype.

- bf16 q (every served call): ``csrc/flash_attention_tc.cu``, both
  products on the tensor cores (wgmma) with K, V and P rounded to bf16
  and fp32 softmax statistics and sums;
- fp32 q (the fp32-compute model checks and parity runs):
  ``csrc/flash_attention.cu``, fp32 math on CUDA cores.

Replaces ``repro.kernels.flash_attention.flash_attention`` and the
padding in ``repro.kernels.ops.flash_attention``.  It takes the
model's layout, q (B,Sq,H,D) and k/v (B,Skv,HKV,D), and returns
(B,Sq,H,D) in q's dtype.  Query row ``i`` sits at absolute position
``q_offset + i``; the masks are ``causal`` (key <= query position), an
optional ``sliding_window`` (key > query - window) and ``kv_len`` (key
< kv_len).  Ragged lengths are masked in the kernel, so there is no
padding and non-causal attention needs no special case.  k and v share
a dtype, fp32 or bf16.

A CPU tensor takes the plain version in ``ref``; a CUDA tensor
launches one of the two kernels or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches since the last reset_launch_counts()
launches_tc = 0     # ... of them on the tensor-core kernel (bf16 q)
launches_f32 = 0    # ... of them on the fp32 CUDA-core kernel (fp32 q)
COUNTERS = ("launches", "launches_tc", "launches_f32")
SOURCE = "src/repro_torch/csrc/flash_attention_tc.cu"
SOURCE_F32 = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:103"
HEAD_DIMS = (64, 112, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,H,D); k, v (B,Skv,HKV,D) -> (B,Sq,H,D)."""
    global launches, launches_tc, launches_f32
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,Sq,H,D) and k/v (B,Skv,HKV,D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Skv, HKV, Dk = k.shape
    if k.shape[0] != B or Dk != D or H % HKV:
        raise ValueError(f"batch/head mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if k.dtype != v.dtype:
        raise TypeError("k and v must share a dtype")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    kv_len = Skv if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        out = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                sliding_window=sliding_window,
                                sm_scale=sm_scale, q_offset=int(q_offset),
                                kv_len=kv_len)
        return out.transpose(1, 2).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel inputs must be contiguous")
    tc = q.dtype == torch.bfloat16
    if not tc and q.dtype != torch.float32:
        raise TypeError(f"flash kernel takes fp32 or bf16 q, got {q.dtype}")
    if tc and (k.data_ptr() % 16 or v.data_ptr() % 16 or q.data_ptr() % 4):
        raise ValueError("tensor-core flash kernel needs 16-byte aligned "
                         "k and v and a 4-byte aligned q")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    _build.launch("flash_attention_tc_fwd" if tc else "flash_attention_fwd",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Skv, H, HKV, D, float(sm_scale), int(bool(causal)),
                  -1 if sliding_window is None else int(sliding_window),
                  int(q_offset), kv_len, _build.dtype_code(k))
    launches += 1
    if tc:
        launches_tc += 1
    else:
        launches_f32 += 1
    return out
