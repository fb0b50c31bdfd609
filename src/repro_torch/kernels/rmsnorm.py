"""Row RMSNorm: wrapper around ``csrc/rmsnorm.cu``.

Replaces ``repro.kernels.rmsnorm.rmsnorm``: ``x (..., d)`` viewed as
``(rows, d)``, ``y = x * rsqrt(mean(x^2) + eps) * scale`` in fp32,
output in x's dtype.  The kernel moves 16-byte vectors where every row
is 16-byte aligned and scalars otherwise (a branch inside the kernel).  A CPU tensor takes the plain version in ``ref``;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches since the last reset_launch_counts()
SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:42"
MAX_D = 16384


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,)."""
    global launches
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    if x.device != scale.device:
        raise ValueError("x and scale must be on one device")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
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
