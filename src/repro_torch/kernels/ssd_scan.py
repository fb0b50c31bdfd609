"""Mamba2 SSD chunked scan: wrapper around two kernels, chosen by the
dtype of x, B and C.

- bf16 (every served call): ``csrc/ssd_scan_tc.cu``, the four products
  of a chunk on the tensor cores, fp32 operands split into bf16 hi + lo
  halves, fp32 sums and decays;
- fp32 (the fp32-compute model checks and parity runs):
  ``csrc/ssd_scan.cu``, fp32 math on CUDA cores.

Replaces ``repro.kernels.ssd_scan.ssd_scan``: x (B,S,H,P), dt (B,S,H),
A and D (H,), B/C (B,S,G,N) and an optional initial state (B,H,P,N);
returns y (B,S,H,P) in x's dtype and the final state (B,H,P,N) in fp32.
Chunks are Q = min(chunk, S) tokens long, the tail chunk ragged.  dt, A,
D and the initial state are read in fp32, as the TPU kernel casts them.

A CPU tensor takes the plain version ``ref.ssd_chunked_ref``; a CUDA
tensor launches one of the two kernels or raises.  There is no backward
kernel yet: a CUDA call that autograd would differentiate raises rather
than return a result cut off from the graph.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches since the last reset_launch_counts()
launches_tc = 0     # ... of them on the tensor-core kernel (bf16 x, B, C)
launches_f32 = 0    # ... of them on the fp32 CUDA-core kernel
COUNTERS = ("launches", "launches_tc", "launches_f32")
SOURCE = "src/repro_torch/csrc/ssd_scan_tc.cu"
SOURCE_F32 = "src/repro_torch/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:115"
HEAD_DIMS = (32, 64)     # P
MAX_STATE = 128          # N
MAX_CHUNK = 128          # Q


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_mat: torch.Tensor, C_mat: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches, launches_tc, launches_f32
    if x.dim() != 4 or B_mat.dim() != 4 or C_mat.shape != B_mat.shape:
        raise ValueError(f"x must be (B,S,H,P) and B/C (B,S,G,N), got "
                         f"{tuple(x.shape)}, {tuple(B_mat.shape)}, "
                         f"{tuple(C_mat.shape)}")
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if (tuple(dt.shape) != (Bsz, S, H) or B_mat.shape[:2] != x.shape[:2]
            or A.shape != (H,) or D.shape != (H,) or G < 1 or H % G):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B_mat.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)}")
    if init_state is not None and tuple(init_state.shape) != (Bsz, H, P, N):
        raise ValueError(f"init_state must be {(Bsz, H, P, N)}, got "
                         f"{tuple(init_state.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    tensors = [x, dt, A, B_mat, C_mat, D] + (
        [] if init_state is None else [init_state])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd_scan inputs must be on one device")
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, A, B_mat, C_mat, D, chunk,
                                   init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if _build.needs_grad(*tensors):
        raise RuntimeError("the SSD scan has no backward kernel yet (the "
                           "ssm and hybrid training slice): call it under "
                           "torch.no_grad()")
    Q = min(chunk, S)
    if P not in HEAD_DIMS or not 0 < N <= MAX_STATE or Q > MAX_CHUNK:
        raise ValueError(f"ssd kernel takes P in {HEAD_DIMS}, "
                         f"N <= {MAX_STATE}, chunk <= {MAX_CHUNK}; got "
                         f"P={P}, N={N}, chunk={Q}")
    if B_mat.dtype != x.dtype or C_mat.dtype != x.dtype:
        raise TypeError(f"x, B and C must share a dtype, got {x.dtype}, "
                        f"{B_mat.dtype}, {C_mat.dtype}")
    tc = x.dtype == torch.bfloat16
    if not tc and x.dtype != torch.float32:
        raise TypeError(f"ssd kernels take fp32 or bf16 x, got {x.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, B_mat, C_mat)):
        raise ValueError("ssd kernel inputs must be contiguous")
    if tc and N % 8:
        raise ValueError(f"tensor-core ssd kernel takes N a multiple of 8, "
                         f"got N={N}")
    dt, A, D = (t.float().contiguous() for t in (dt, A, D))
    h0 = None if init_state is None else init_state.float().contiguous()
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if tc and (any(t.data_ptr() % 16 for t in (x, B_mat, C_mat))
               or (h0 is not None and h0.data_ptr() % 8)):
        raise ValueError("tensor-core ssd kernel needs 16-byte aligned x, "
                         "B and C and an 8-byte aligned initial state")
    if Bsz == 0 or H == 0 or S == 0:
        state.copy_(h0 if h0 is not None else torch.zeros_like(state))
        return y, state
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
            C_mat.data_ptr(), D.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            state.data_ptr(), Bsz, S, H, G, P, N, Q)
    if tc:
        _build.launch("ssd_scan_tc_fwd", *args)
        launches_tc += 1
    else:
        _build.launch("ssd_scan_fwd", *args)
        launches_f32 += 1
    launches += 1
    return y, state

