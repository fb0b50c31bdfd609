"""Blocked (flash) attention for prefill and training: wrapper around
two forward kernels, chosen by q's dtype, and one backward kernel.

- bf16 q (every served call): ``csrc/flash_attention_tc.cu``, both
  products on the tensor cores (wgmma) with K, V and P rounded to bf16
  and fp32 softmax statistics and sums;
- fp32 q (the fp32-compute model checks and parity runs):
  ``csrc/flash_attention.cu``, fp32 math on CUDA cores;
- the gradient, chosen by dtype, head_dim 64, 112 or 128: bf16 q, k, v
  (every bf16 training step) ``csrc/flash_attention_bwd_tc.cu``, its five
  products on the tensor cores (wgmma) with P and dS rounded to bf16 and
  fp32 sums; fp32 (the fp32 training gate)
  ``csrc/flash_attention_bwd.cu``, fp32 math on CUDA cores.

Replaces ``repro.kernels.flash_attention.flash_attention`` and the
padding in ``repro.kernels.ops.flash_attention``.  It takes the
model's layout, q (B,Sq,H,D) and k/v (B,Skv,HKV,D), and returns
(B,Sq,H,D) in q's dtype.  Query row ``i`` sits at absolute position
``q_offset + i``; the masks are ``causal`` (key <= query position), an
optional ``sliding_window`` (key > query - window) and ``kv_len`` (key
< kv_len).  Ragged lengths are masked in the kernel, so there is no
padding and non-causal attention needs no special case.  k and v share
a dtype, fp32 or bf16.

A CPU tensor takes the plain version in ``ref`` (autograd differentiates
it).  A CUDA call that autograd will differentiate goes through
``FlashAttentionFn``: the forward kernel also writes the rows'
log-sum-exp, and the backward launches the backward kernel.  Any other
CUDA call (serving, under ``torch.no_grad()``) launches the forward
kernel alone; otherwise the wrapper raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches since the last reset_launch_counts()
launches_tc = 0     # ... of them on the tensor-core kernel (bf16 q)
launches_f32 = 0    # ... of them on the fp32 CUDA-core kernel (fp32 q)
COUNTERS = ("launches", "launches_tc", "launches_f32")
launches_bwd = 0    # backward kernel calls since the last reset
launches_bwd_tc = 0   # ... of them on the tensor-core kernel (bf16)
launches_bwd_f32 = 0  # ... of them on the fp32 CUDA-core kernel
COUNTERS_BWD = ("launches_bwd", "launches_bwd_tc", "launches_bwd_f32")
SOURCE = "src/repro_torch/csrc/flash_attention_tc.cu"
SOURCE_F32 = "src/repro_torch/csrc/flash_attention.cu"
SOURCE_BWD = "src/repro_torch/csrc/flash_attention_bwd_tc.cu"
SOURCE_BWD_F32 = "src/repro_torch/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/kernels/flash_attention.py:103"
# no TPU backward kernel: XLA differentiates the reference's jnp attention
REPLACES_BWD = "src/repro/models/layers.py:116"
HEAD_DIMS = (64, 112, 128)
BWD_HEAD_DIMS = (64, 112, 128)


def _launch_forward(q, k, v, causal, sliding_window, sm_scale, q_offset,
                    kv_len, lse=None) -> torch.Tensor:
    """One forward launch on CUDA tensors; ``lse`` (B,H,Sq) fp32, when
    given, receives the rows' log-sum-exp."""
    global launches, launches_tc, launches_f32
    B, Sq, H, D = q.shape
    _, Skv, HKV, _ = k.shape
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
                  None if lse is None else lse.data_ptr(),
                  B, Sq, Skv, H, HKV, D, float(sm_scale), int(bool(causal)),
                  -1 if sliding_window is None else int(sliding_window),
                  int(q_offset), kv_len, _build.dtype_code(k))
    launches += 1
    if tc:
        launches_tc += 1
    else:
        launches_f32 += 1
    return out


def check_backward(head_dim: int, q_dtype: torch.dtype,
                   kv_dtype: torch.dtype) -> None:
    """Raise unless the backward kernels take attention of this head_dim
    and these dtypes: head_dim in ``BWD_HEAD_DIMS``, and q, k and v of
    one dtype, fp32 or bf16.  A training entry point checks its config
    with it before its first step."""
    if head_dim not in BWD_HEAD_DIMS:
        raise ValueError(f"flash backward takes head_dim in "
                         f"{BWD_HEAD_DIMS}, got {head_dim}")
    if kv_dtype != q_dtype:
        raise TypeError(f"flash backward needs q, k, v of one dtype, got "
                        f"{q_dtype} and {kv_dtype}")
    if q_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash backward takes fp32 or bf16, got {q_dtype}")


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel (with the log-sum-exp) and the backward kernel,
    for CUDA q, k, v of one dtype; saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, sm_scale, q_offset,
                kv_len):
        B, Sq, H, D = q.shape
        check_backward(D, q.dtype, k.dtype)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out = _launch_forward(q, k, v, causal, sliding_window, sm_scale,
                              q_offset, kv_len, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sliding_window, sm_scale, q_offset, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, out, dout.contiguous(), lse,
                                      *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _launch_backward(q, k, v, out, dout, lse, causal, sliding_window,
                     sm_scale, q_offset, kv_len):
    """One backward call (three launches: delta, dK/dV, dQ) on the
    forward's inputs, output and log-sum-exp; returns (dq, dk, dv).  bf16
    takes the tensor-core kernel, which reads 16-byte vectors: an
    operand that does not start on a 16-byte boundary (autograd may hand
    in a view) is copied to one that does."""
    global launches_bwd, launches_bwd_tc, launches_bwd_f32
    B, Sq, H, D = q.shape
    _, Skv, HKV, _ = k.shape
    tc = q.dtype == torch.bfloat16
    if not tc and q.dtype != torch.float32:
        raise TypeError(f"flash backward takes fp32 or bf16, got {q.dtype}")
    dout = dout.to(q.dtype)
    if tc:
        q, k, v, out, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                              for t in (q, k, v, out, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not (B and Sq and Skv):
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _build.launch("flash_attention_tc_bwd" if tc else "flash_attention_bwd",
                  q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, HKV, D,
                  float(sm_scale), int(bool(causal)),
                  -1 if sliding_window is None else int(sliding_window),
                  int(q_offset), kv_len, _build.dtype_code(q))
    launches_bwd += 1
    if tc:
        launches_bwd_tc += 1
    else:
        launches_bwd_f32 += 1
    return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,H,D); k, v (B,Skv,HKV,D) -> (B,Sq,H,D)."""
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
    if _build.needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, sliding_window,
                                      sm_scale, int(q_offset), kv_len)
    return _launch_forward(q, k, v, causal, sliding_window, sm_scale,
                           int(q_offset), kv_len)
