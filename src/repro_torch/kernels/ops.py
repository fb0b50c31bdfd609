"""Model-layout adapters around the kernel wrappers (mirrors
``repro.kernels.ops``).

The model calls these.  By default each goes to its kernel wrapper,
which launches the CUDA kernel for a CUDA tensor and runs the plain
version for a CPU tensor.  Inside ``with plain_versions():`` they call
the plain versions in ``ref`` on any device instead: that is how a check
on the card holds the model's kernel path against its plain path on the
same inputs.  Nothing on the serving path enters that context.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd

_PLAIN = contextvars.ContextVar("repro_torch_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Route the adapters below to the plain PyTorch versions."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_enabled() -> bool:
    """Whether the adapters route to the plain versions here.  A remat
    recompute runs in the backward pass, on autograd's thread, where the
    caller's ``plain_versions()`` is not set: it reads this first."""
    return _PLAIN.get()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None,
                    q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Model layout: q (B,Sq,H,D); k,v (B,Skv,HKV,D) -> (B,Sq,H,D)."""
    D = q.shape[-1]
    if _PLAIN.get():
        out = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                sliding_window=sliding_window,
                                sm_scale=1.0 / (D ** 0.5), q_offset=q_offset,
                                kv_len=kv_len)
        return out.transpose(1, 2).contiguous()
    return _fa.flash_attention(q, k, v, causal=causal,
                               sliding_window=sliding_window,
                               sm_scale=1.0 / (D ** 0.5), q_offset=q_offset,
                               kv_len=kv_len)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """Model layout: q (B,1,H,D) single decode token per sequence;
    k/v pages (P,ps,KV,D); page_table (B,PMAX); lengths (B,) valid KV
    tokens (including the just-written one) -> (B,1,H,D)."""
    B, S, H, D = q.shape
    if S != 1:
        raise ValueError("paged attention is a decode (one-query) kernel")
    fn = ref.paged_attention_ref if _PLAIN.get() \
        else _pa.paged_decode_attention
    out = fn(q[:, 0].contiguous(), k_pages, v_pages, page_table, lengths,
             sm_scale=1.0 / (D ** 0.5), sliding_window=sliding_window)
    return out[:, None]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    if _PLAIN.get():
        return ref.rmsnorm_ref(x, scale, eps)
    return _rn.rmsnorm(x, scale, eps=eps)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_mat: torch.Tensor, C_mat: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x (B,S,H,P); dt (B,S,H); A, D (H,); B/C (B,S,G,N)
    -> (y (B,S,H,P), final state (B,H,P,N) fp32)."""
    fn = ref.ssd_chunked_ref if _PLAIN.get() else _ssd.ssd_scan
    return fn(x, dt, A, B_mat, C_mat, D, chunk=chunk, init_state=init_state)
