"""Mamba2 SSD chunked scan: wrapper around two forward kernels and two
backward kernels, each pair chosen by the dtype of x, B and C.

- bf16 (every served call): ``csrc/ssd_scan_tc.cu``, the four products
  of a chunk on the tensor cores, fp32 operands split into bf16 hi + lo
  halves, fp32 sums and decays;
- fp32 (the fp32-compute model checks and parity runs):
  ``csrc/ssd_scan.cu``, fp32 math on CUDA cores;
- the gradient, over chunks of ``min(Q, BWD_CHUNK)`` positions: bf16
  (every bf16 training step) ``csrc/ssd_scan_bwd_tc.cu`` on the tensor
  cores, with hi + lo splits of the fp32 operands and dB, dC summed over
  runs of ``bwd_run(...)`` heads in a block; fp32 (the fp32 gates)
  ``csrc/ssd_scan_bwd.cu``, fp32 math on CUDA cores.  Both take N a
  multiple of 8 in bf16, as the forward does.

Replaces ``repro.kernels.ssd_scan.ssd_scan``: x (B,S,H,P), dt (B,S,H),
A and D (H,), B/C (B,S,G,N) and an optional initial state (B,H,P,N);
returns y (B,S,H,P) in x's dtype and the final state (B,H,P,N) in fp32.
Chunks are Q = min(chunk, S) tokens long, the tail chunk ragged.  dt, A,
D and the initial state are read in fp32, as the TPU kernel casts them;
the casts happen before the kernels, so autograd returns each gradient
in its input's dtype.

A CPU tensor takes the plain version ``ref.ssd_chunked_ref`` (autograd
differentiates it).  A CUDA call that autograd will differentiate goes
through ``SSDScanFn``: the forward kernel, then the backward kernel
(the final state's gradient may be None, as in training, or a tensor).
Any other CUDA call (serving, under ``torch.no_grad()``) launches the
forward kernel alone; otherwise the wrapper raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches since the last reset_launch_counts()
launches_tc = 0     # ... of them on the tensor-core kernel (bf16 x, B, C)
launches_f32 = 0    # ... of them on the fp32 CUDA-core kernel
COUNTERS = ("launches", "launches_tc", "launches_f32")
launches_bwd = 0    # backward kernel calls since the last reset
launches_bwd_tc = 0     # ... of them on the tensor-core kernel (bf16)
launches_bwd_f32 = 0    # ... of them on the fp32 CUDA-core kernel
COUNTERS_BWD = ("launches_bwd", "launches_bwd_tc", "launches_bwd_f32")
SOURCE = "src/repro_torch/csrc/ssd_scan_tc.cu"
SOURCE_F32 = "src/repro_torch/csrc/ssd_scan.cu"
SOURCE_BWD = "src/repro_torch/csrc/ssd_scan_bwd_tc.cu"
SOURCE_BWD_F32 = "src/repro_torch/csrc/ssd_scan_bwd.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:115"
# no TPU backward kernel: XLA differentiates the reference's jnp scan
REPLACES_BWD = "src/repro/models/mamba2.py:32"
HEAD_DIMS = (32, 64)     # P
MAX_STATE = 128          # N
MAX_CHUNK = 128          # Q
BWD_CHUNK = 64           # the backward's chunk: min(Q, BWD_CHUNK)
BWD_RUN = 8              # heads of a group whose dB, dC one block sums
H100_SMS = 132


def bwd_run(Bsz: int, S: int, H: int, G: int, Q: int) -> int:
    """Heads a block of the bf16 backward sums dB and dC over: BWD_RUN,
    halved while the grid (chunks x runs x batch, one block an SM) would
    give the H100's SMs fewer than two blocks each."""
    nc = -(-S // min(Q, BWD_CHUNK))
    run = BWD_RUN
    while run > 1 and nc * G * -(-(H // G) // run) * Bsz < 2 * H100_SMS:
        run //= 2
    return run


def check_backward(P: int, N: int, chunk: int, dtype: torch.dtype) -> None:
    """Raise unless the kernels take a differentiated scan of head_dim P,
    state N and chunk length ``chunk`` with x, B and C in ``dtype``.  A
    training entry point checks its config with it before its first
    step."""
    if P not in HEAD_DIMS or not 0 < N <= MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"ssd kernel takes P in {HEAD_DIMS}, "
                         f"N <= {MAX_STATE}, chunk <= {MAX_CHUNK}; got "
                         f"P={P}, N={N}, chunk={chunk}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd kernels take fp32 or bf16 x, got {dtype}")
    if dtype == torch.bfloat16 and N % 8:
        raise ValueError(f"tensor-core ssd kernel takes N a multiple of 8, "
                         f"got N={N}")


def _launch_forward(x, dt, A, B_mat, C_mat, D, h0, Q):
    """One forward launch on checked CUDA tensors (dt, A, D, h0 fp32)."""
    global launches, launches_tc, launches_f32
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if Bsz == 0 or H == 0 or S == 0:
        state.copy_(h0 if h0 is not None else torch.zeros_like(state))
        return y, state
    tc = x.dtype == torch.bfloat16
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


def _launch_backward(x, dt, A, B_mat, C_mat, D, h0, dy, dstate, Q,
                     run=None):
    """One backward call (three launches: the chunk-boundary states and
    their gradients, the per-chunk terms, the fixed-order sums over heads
    and chunks) on the forward's inputs, on the tensor-core kernel for
    bf16 x, B and C (dB, dC summed over runs of ``run`` heads, by default
    ``bwd_run``) and the CUDA-core one for fp32; returns (dx, ddt, dA, dB,
    dC, dD, dh0), dh0 None without an initial state."""
    global launches_bwd, launches_bwd_tc, launches_bwd_f32
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
    dhT = None if dstate is None else dstate.float().contiguous()
    dx, dB, dC = (torch.empty_like(t) for t in (x, B_mat, C_mat))
    ddt = torch.empty_like(dt)
    dA, dD = torch.empty(H, **f32), torch.empty(H, **f32)
    if Bsz == 0 or H == 0 or S == 0:
        dh0 = None if h0 is None else (
            torch.zeros_like(h0) if dhT is None else dhT.clone())
        return (dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_(),
                dD.zero_(), dh0)
    Qb = min(Q, BWD_CHUNK)
    nc = -(-S // Qb)
    pAD = torch.empty((2, Bsz, nc, H), **f32)
    common = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
              C_mat.data_ptr(), D.data_ptr(),
              None if h0 is None else h0.data_ptr())
    if x.dtype == torch.bfloat16:
        if dy.data_ptr() % 16:
            dy = dy.clone()
        if dhT is not None and dhT.data_ptr() % 8:
            dhT = dhT.clone()
        run = bwd_run(Bsz, S, H, G, Q) if run is None else run
        if run < 1:
            raise ValueError(f"ssd backward run must be >= 1, got {run}")
        runs = G * -(-(H // G) // run)
        hs = torch.empty((Bsz, nc, H, 2, P, N), dtype=torch.bfloat16,
                         device=x.device)
        gs = torch.empty_like(hs)
        pB = torch.empty((Bsz, S, runs, N), **f32)
        pC = torch.empty((Bsz, S, runs, N), **f32)
        dh0 = None if h0 is None else torch.empty_like(h0)
        _build.launch("ssd_scan_tc_bwd", *common, dy.data_ptr(),
                      None if dhT is None else dhT.data_ptr(),
                      dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                      dD.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                      None if dh0 is None else dh0.data_ptr(),
                      hs.data_ptr(), gs.data_ptr(), pB.data_ptr(),
                      pC.data_ptr(), pAD.data_ptr(), Bsz, S, H, G, P, N, Qb,
                      run)
        launches_bwd_tc += 1
    else:
        states = torch.empty((Bsz, H, nc + 1, P, N), **f32)
        dstates = torch.empty((Bsz, H, nc + 1, P, N), **f32)
        pB = torch.empty((Bsz, S, H, N), **f32)
        pC = torch.empty((Bsz, S, H, N), **f32)
        _build.launch("ssd_scan_bwd", *common, dy.data_ptr(),
                      None if dhT is None else dhT.data_ptr(),
                      dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                      dD.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                      states.data_ptr(), dstates.data_ptr(), pB.data_ptr(),
                      pC.data_ptr(), pAD.data_ptr(), Bsz, S, H, G, P, N, Qb,
                      _build.dtype_code(x))
        launches_bwd_f32 += 1
        dh0 = None if h0 is None else dstates[:, :, 0].clone()
    launches_bwd += 1
    return dx, ddt, dA, dB, dC, dD, dh0


class SSDScanFn(torch.autograd.Function):
    """The forward kernel and the backward kernel, for checked CUDA
    tensors (dt, A, D and the initial state already fp32); saves the
    inputs, not y or the state."""

    @staticmethod
    def forward(ctx, x, dt, A, B_mat, C_mat, D, h0, Q):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B_mat, C_mat, D, h0)
        ctx.Q = Q
        return _launch_forward(x, dt, A, B_mat, C_mat, D, h0, Q)

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = _launch_backward(*ctx.saved_tensors, dy, dstate, ctx.Q)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_mat: torch.Tensor, C_mat: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
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
    Q = min(chunk, S)
    if B_mat.dtype != x.dtype or C_mat.dtype != x.dtype:
        raise TypeError(f"x, B and C must share a dtype, got {x.dtype}, "
                        f"{B_mat.dtype}, {C_mat.dtype}")
    check_backward(P, N, Q, x.dtype)
    if not all(t.is_contiguous() for t in (x, dt, B_mat, C_mat)):
        raise ValueError("ssd kernel inputs must be contiguous")
    dt, A, D = (t.float().contiguous() for t in (dt, A, D))
    h0 = None if init_state is None else init_state.float().contiguous()
    if x.dtype == torch.bfloat16 and (
            any(t.data_ptr() % 16 for t in (x, B_mat, C_mat))
            or (h0 is not None and h0.data_ptr() % 8)):
        raise ValueError("tensor-core ssd kernel needs 16-byte aligned x, "
                         "B and C and an 8-byte aligned initial state")
    if _build.needs_grad(x, dt, A, B_mat, C_mat, D, h0):
        return SSDScanFn.apply(x, dt, A, B_mat, C_mat, D, h0, Q)
    return _launch_forward(x, dt, A, B_mat, C_mat, D, h0, Q)
