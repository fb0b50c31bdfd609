"""Row RMSNorm: wrapper around ``csrc/rmsnorm.cu`` and its backward
``csrc/rmsnorm_bwd.cu``.

Replaces ``repro.kernels.rmsnorm.rmsnorm``: ``x (..., d)`` viewed as
``(rows, d)``, ``y = x * rsqrt(mean(x^2) + eps) * scale`` in fp32,
output in x's dtype.  The kernel moves 16-byte vectors where every row
is 16-byte aligned and scalars otherwise (a branch inside the kernel).
A CPU tensor takes the plain version in ``ref`` (autograd differentiates
it).  A CUDA call that autograd will differentiate goes through
``RMSNormFn``, whose backward launches the backward kernel (it
recomputes each row's rsqrt from x; the forward saves x and scale
only; rows up to ``BWD_WARP_MAX_D`` wide take a warp each, wider ones a
team of 256 threads, 1024 beyond 8192; either holds the row in its
registers).  Any other CUDA call launches the
forward kernel; otherwise the wrapper raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches since the last reset_launch_counts()
launches_bwd = 0    # backward kernel calls since the last reset
SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
SOURCE_BWD = "src/repro_torch/csrc/rmsnorm_bwd.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:42"
# no TPU backward kernel: XLA differentiates the reference's jnp RMSNorm
REPLACES_BWD = "src/repro/models/layers.py:40"
MAX_D = 16384
# the backward takes a warp per row up to BWD_WARP_MAX_D, 16 warps a
# block and at most one block per H100 SM; wider rows a team of threads
# per row (two teams a block, a run of rows a block, each team's next
# row's loads in flight): a block a SM, two up to BWD_WIDE_SMALL_D (the
# kernel's registers allow it there)
BWD_WARP_MAX_D = 1024
BWD_WARPS = 16
BWD_BLOCKS = 132
BWD_WIDE_SMALL_D = 2048


def _launch_forward(x: torch.Tensor, scale: torch.Tensor,
                    eps: float) -> torch.Tensor:
    global launches
    d = x.shape[-1]
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm kernel takes 0 < d <= {MAX_D}, got {d}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel inputs must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    # 16-byte vectors where every row (bit 0) or scale (bit 1) starts on
    # a 16-byte boundary
    vec = (int(d * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
           | 2 * int(d * scale.element_size() % 16 == 0
                     and scale.data_ptr() % 16 == 0))
    _build.launch("rmsnorm_fwd", x.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), rows, d, float(eps), _build.dtype_code(x),
                  _build.dtype_code(scale), vec)
    launches += 1
    return out


class RMSNormFn(torch.autograd.Function):
    """The forward kernel and the backward kernel (dx per row, dscale as
    per-block partial sums added in a fixed order); saves x and scale."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch_forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _launch_backward(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


def _launch_backward(x, scale, dy, eps):
    """One backward call (two launches: dx with the per-block dscale
    partial sums, then their fixed-order sum); returns (dx, dscale)."""
    global launches_bwd
    d = x.shape[-1]
    rows = x.numel() // d
    dy = dy.to(x.dtype)
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if rows == 0:
        return dx, dscale.zero_()
    blocks = (min(-(-rows // BWD_WARPS), BWD_BLOCKS) if d <= BWD_WARP_MAX_D
              else min(rows, BWD_BLOCKS * (2 if d <= BWD_WIDE_SMALL_D
                                           else 1)))
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    _build.launch("rmsnorm_bwd", x.data_ptr(), scale.data_ptr(),
                  dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                  partial.data_ptr(), rows, d, float(eps),
                  _build.dtype_code(x), _build.dtype_code(scale), blocks)
    launches_bwd += 1
    return dx, dscale


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,)."""
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    if x.device != scale.device:
        raise ValueError("x and scale must be on one device")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if _build.needs_grad(x, scale):
        return RMSNormFn.apply(x, scale, eps)
    return _launch_forward(x, scale, eps)
