"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test skips (a CUDA kernel
has no CPU mode; the plain versions are held against the reference in
``tests/test_torch_kernels.py``).  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: 1e-5 in fp32, 2e-2 when q is bf16; the SSD scan 2e-4 in
fp32 (its sums run in another order than the plain version's) and 2e-2
for bf16 y, with the fp32 state of the tensor-core kernel (bf16 x, B, C)
held at 2e-4 as well.  The tensor-core flash kernel (bf16 q) is also
held against the emulation of its numerical contract
(``tests/_flash_emulation.py``) at ``EMU_TOL``; the split-KV paged
kernel against the transcription of its algorithm
(``tests/_paged_emulation.py``) at the paged tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _flash_emulation import flash_tc_emulation               # noqa: E402
from _paged_emulation import paged_split_emulation            # noqa: E402
from _ssd_emulation import ssd_tc_emulation                   # noqa: E402
from repro_torch import kernels                               # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402,E501
from repro_torch.kernels.rmsnorm import rmsnorm               # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan             # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# kernel vs the emulation of its contract, both rounding K, V and P to
# bf16: rtol 2^-7 is one ulp of a bf16 output (a rounding flip), atol
# covers P's rounding against the running row max (the emulation rounds
# against the final max): 2^-8 relative per probability at most
EMU_TOL = {"atol": 5e-3, "rtol": 2 ** -7}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [("float32", "float32"),
                                              ("bfloat16", "float32"),
                                              ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("D", [64, 128])
def test_cuda_paged_kernel_matches_plain(cuda, q_dtype, kv_dtype, D):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, KV, G, ps, PMAX, P = 5, 4, 2, 16, 6, 40
    q = torch.randn(B, KV * G, D, generator=g, device=cuda).to(
        getattr(torch, q_dtype))
    kp, vp = (torch.randn(P, ps, KV, D, generator=g, device=cuda).to(
        getattr(torch, kv_dtype)) for _ in range(2))
    pt = torch.randint(0, P, (B, PMAX), generator=g, device=cuda,
                       dtype=torch.int32)
    lengths = torch.tensor([0, 1, 17, 64, PMAX * ps], device=cuda,
                           dtype=torch.int32)
    for window in (None, 20):
        got = paged_decode_attention(q, kp, vp, pt, lengths,
                                     sliding_window=window)
        want = ref.paged_attention_ref(q, kp, vp, pt, lengths,
                                       sliding_window=window)
        torch.cuda.synchronize()
        _close(got, want, TOL[q_dtype])
        assert torch.all(got[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [64, 130])
@pytest.mark.parametrize("D", [64, 112, 128])
def test_cuda_flash_kernel_matches_plain(cuda, Sq, D):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, Sq, 8, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, Sq, 4, D, generator=g, device=cuda)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=True)
    with ops.plain_versions():
        want = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _close(got, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 15, 64, 65, 130, 500, 512, 1024])
@pytest.mark.parametrize("D", [64, 112, 128])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
def test_cuda_flash_tc_kernel_grid(cuda, Sq, D, kv_dtype, G):
    """bf16 q on the tensor-core kernel: every prefill bucket and a
    decode query, each head_dim, the fp32 cache and bf16 K/V, MHA and
    GQA; against the plain version and the emulated contract."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, Sq, 8, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, Sq, 8 // G, D, generator=g, device=cuda).to(
        getattr(torch, kv_dtype)) for _ in range(2))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    assert kernels.variant_counts() == {"flash_attention.tc": 1,
                                        "flash_attention.f32": 0,
                                        "ssd_scan.tc": 0, "ssd_scan.f32": 0}
    with ops.plain_versions():
        want = ops.flash_attention(q, k, v, causal=True)
    emu = flash_tc_emulation(q, k, v, causal=True)
    torch.cuda.synchronize()
    _close(got, want, 2e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               emu.float().cpu().numpy(), **EMU_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D,kv_dtype", [(64, "float32"), (112, "float32"),
                                        (128, "bfloat16")])
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_cuda_flash_masks_and_empty_rows(cuda, D, kv_dtype, q_dtype):
    """Sliding window, q_offset and kv_len < Skv together, GQA G=4, on
    both kernels; with window 8 and kv_len 13 the rows at positions >= 20
    see no key and are exact zeros.  The counters show the variant."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(2, 70, 8, D, generator=g, device=cuda).to(
        getattr(torch, q_dtype))
    k, v = (torch.randn(2, 96, 2, D, generator=g, device=cuda).to(
        getattr(torch, kv_dtype)) for _ in range(2))
    variant = "tc" if q_dtype == "bfloat16" else "f32"
    for kw in (dict(sliding_window=24, q_offset=10, kv_len=80),
               dict(sliding_window=8, q_offset=0, kv_len=13)):
        kernels.reset_launch_counts()
        got = flash_attention(q, k, v, causal=True, **kw)
        counts = kernels.variant_counts()
        assert counts[f"flash_attention.{variant}"] == 1
        assert sum(counts.values()) == 1
        with ops.plain_versions():
            want = ops.flash_attention(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        _close(got, want, TOL[q_dtype])
        if q_dtype == "bfloat16":
            emu = flash_tc_emulation(q, k, v, causal=True, **kw)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       emu.float().cpu().numpy(), **EMU_TOL)
        if kw["kv_len"] == 13:
            assert torch.all(got[:, 20:] == 0)
            assert torch.any(got[:, :20] != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 112, 128])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_cuda_flash_fp32_q_on_the_cuda_core_kernel(cuda, D, kv_dtype):
    """fp32 q stays on the fp32 CUDA-core kernel, within 1e-5."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(2, 130, 8, D, generator=g, device=cuda)
    k, v = (torch.randn(2, 130, 2, D, generator=g, device=cuda).to(
        getattr(torch, kv_dtype)) for _ in range(2))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    assert kernels.variant_counts() == {"flash_attention.tc": 0,
                                        "flash_attention.f32": 1,
                                        "ssd_scan.tc": 0, "ssd_scan.f32": 0}
    with ops.plain_versions():
        want = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _close(got, want, TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 7, 8, 33, 300, 500, 4000])
@pytest.mark.parametrize("d", [64, 1000, 1001, 1024, 1536, 3072, 3584,
                               7168])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_kernel_matches_plain(cuda, rows, d, scale_dtype):
    """bf16 rows at every width the serving paths give the kernel:
    qwen1.5-0.5b's 64 (qk) and 1024, mamba2-780m's 1536 and 3072,
    zamba2-7b's 3584 and 7168 (a 256-thread block per row); d = 1000 (a
    vector path that ends mid-group) and 1001 (the scalar branch: a tail,
    and rows that are not 16-byte aligned); row counts that are not a
    multiple of the rows a block takes.  The scale in fp32 or, as the
    served models hold it, bf16."""
    x = torch.randn(rows, d, device=cuda).bfloat16()
    s = (1 + 0.1 * torch.randn(d, device=cuda)).to(getattr(torch,
                                                           scale_dtype))
    got = rmsnorm(x, s)
    want = ref.rmsnorm_ref(x, s)
    torch.cuda.synchronize()
    _close(got, want, 2e-2)


@pytest.mark.cuda
def test_cuda_flash_kernel_decode_shape_at_head_dim_112(cuda):
    """zamba2's shared block at decode: one query at an offset into a
    longer fp32 cache, ``kv_len`` masking its unwritten tail."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(3, 1, 8, 112, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(3, 96, 8, 112, generator=g, device=cuda)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=True, q_offset=70, kv_len=71)
    with ops.plain_versions():
        want = ops.flash_attention(q, k, v, causal=True, q_offset=70,
                                   kv_len=71)
    torch.cuda.synchronize()
    _close(got, want, 2e-2)


def _ssd_inputs(g, B, S, H, G, N, dtype, dev, P=64):
    x = torch.randn(B, S, H, P, generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device=dev))
    A = -torch.exp(0.5 * torch.randn(H, generator=g, device=dev))
    Bm, Cm = ((torch.randn(B, S, G, N, generator=g, device=dev)
               / N ** 0.5).to(dtype) for _ in range(2))
    D = torch.ones(H, device=dev)
    return x, dt, A, Bm, Cm, D


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,G,N,chunk", [(300, 4, 1, 128, 128),
                                           (200, 6, 2, 64, 64),
                                           (50, 2, 1, 16, 128),
                                           (129, 4, 4, 32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_kernel_matches_plain(cuda, S, H, G, N, chunk, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    dt_ = getattr(torch, dtype)
    args = _ssd_inputs(g, 2, S, H, G, N, dt_, cuda)
    h0 = torch.randn(2, H, 64, N, generator=g, device=cuda)
    for init in (None, h0):
        y, h = ssd_scan(*args, chunk=chunk, init_state=init)
        wy, wh = ref.ssd_chunked_ref(*args, chunk, init_state=init)
        torch.cuda.synchronize()
        assert y.dtype == dt_ and h.dtype == torch.float32
        _close(y, wy, 2e-4 if dtype == "float32" else 2e-2)
        _close(h, wh, 2e-4 if dtype == "float32" else 2e-2)


@pytest.mark.cuda
def test_cuda_ssd_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    x, dt, A, Bm, Cm, D = _ssd_inputs(g, 1, 16, 2, 1, 256, torch.float32,
                                      cuda)
    with pytest.raises(ValueError, match="N <="):
        ssd_scan(x, dt, A, Bm, Cm, D)
    x, dt, A, Bm, Cm, D = _ssd_inputs(g, 1, 16, 2, 1, 64, torch.float32,
                                      cuda)
    with pytest.raises(TypeError):
        ssd_scan(x, dt, A, Bm.bfloat16(), Cm.bfloat16(), D)


def _paged_batch(g, dev, lengths, ps, q_dtype, kv_dtype, H=16, KV=16,
                 D=64, PMAX=16):
    """One decode batch, each row on its own shuffled pages of a pool
    with a trash page last."""
    B = len(lengths)
    P = B * PMAX + 1
    q = torch.randn(B, H, D, generator=g, device=dev).to(q_dtype)
    kp, vp = (torch.randn(P, ps, KV, D, generator=g, device=dev).to(kv_dtype)
              for _ in range(2))
    table = torch.randperm(P - 1, generator=g, device=dev)[:B * PMAX]
    table = table.reshape(B, PMAX).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 100])
def test_cuda_paged_row_output_does_not_change_with_the_batch(cuda, window):
    """Split-KV: a row decoded alone (B = 1, a table cut to its live
    pages) and inside B = 8 gives bitwise the same output, and the
    layout of the pool does not change it either."""
    g = torch.Generator(device=cuda).manual_seed(8)
    lengths = [300, 0, 1, 64, 65, 563, 130, 1024]
    q, kp, vp, table, lens = _paged_batch(g, cuda, lengths, 64,
                                          torch.bfloat16, torch.float32)
    full = paged_decode_attention(q, kp, vp, table, lens,
                                  sliding_window=window)
    for b, n in enumerate(lengths):
        pages = max(1, -(-n // 64))
        alone = paged_decode_attention(
            q[b:b + 1].contiguous(), kp, vp,
            table[b:b + 1, :pages].contiguous(), lens[b:b + 1],
            sliding_window=window)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], full[b]), (b, n)
    perm = torch.randperm(kp.shape[0], generator=g, device=cuda)
    kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
    kp2[perm], vp2[perm] = kp, vp
    moved = paged_decode_attention(q, kp2, vp2,
                                   perm[table.long()].to(torch.int32), lens,
                                   sliding_window=window)
    torch.cuda.synchronize()
    assert torch.equal(moved, full)
    _close(full, ref.paged_attention_ref(q, kp, vp, table, lens,
                                         sliding_window=window),
           TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
def test_cuda_paged_bf16_pool_ps16_window_mid_split(cuda, q_dtype, G):
    """A bf16 pool of 16-token pages, GQA, a 40-token window whose start
    falls inside a 64-position split; against the plain version and the
    split-KV transcription."""
    g = torch.Generator(device=cuda).manual_seed(9)
    lengths = [0, 1, 16, 17, 100, 130, 250, 256]
    q, kp, vp, table, lens = _paged_batch(
        g, cuda, lengths, 16, getattr(torch, q_dtype), torch.bfloat16,
        H=8 * G, KV=8, PMAX=16)
    got = paged_decode_attention(q, kp, vp, table, lens, sliding_window=40)
    want = ref.paged_attention_ref(q, kp, vp, table, lens,
                                   sliding_window=40)
    emu = paged_split_emulation(q, kp, vp, table, lens, sliding_window=40)
    torch.cuda.synchronize()
    _close(got, want, TOL[q_dtype])
    _close(got, emu, TOL[q_dtype])
    assert torch.all(got[0] == 0)


# the SSD grid of the tensor-core kernel: (S, chunk, N, P, G)
SSD_TC_GRID = [(S, chunk, N, P, G) for S in (1, 100, 128, 129, 500, 1000)
               for chunk in (64, 128) for N in (64, 128) for P in (32, 64)
               for G in (1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,chunk,N,P,G", SSD_TC_GRID)
def test_cuda_ssd_tc_kernel_grid(cuda, S, chunk, N, P, G, init):
    """bf16 x, B and C on the tensor-core kernel: y within 2e-2, the
    fp32 state within 2e-4 of the plain version, with and without an
    initial state; one launch, on the tc variant."""
    g = torch.Generator(device=cuda).manual_seed(10)
    args = _ssd_inputs(g, 2, S, 4, G, N, torch.bfloat16, cuda, P=P)
    h0 = torch.randn(2, 4, P, N, generator=g, device=cuda) if init else None
    kernels.reset_launch_counts()
    y, h = ssd_scan(*args, chunk=chunk, init_state=h0)
    assert kernels.variant_counts()["ssd_scan.tc"] == 1
    assert kernels.launch_counts()["ssd_scan"] == 1
    wy, wh = ref.ssd_chunked_ref(*args, chunk, init_state=h0)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(y, wy, 2e-2)
    _close(h, wh, 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,H,N", [("mamba2", 48, 128),
                                      ("zamba2", 112, 64)])
def test_cuda_ssd_tc_matches_emulation(cuda, arch, H, N):
    """At a served head layout (two rows of 500 tokens): the tensor-core
    kernel agrees with the emulated contract within the smoke's
    tolerances, and a second call (the launch plan then cached) gives
    bitwise the same result."""
    g = torch.Generator(device=cuda).manual_seed(11)
    args = _ssd_inputs(g, 2, 500, H, 1, N, torch.bfloat16, cuda)
    y1, h1 = ssd_scan(*args, chunk=128)
    y2, h2 = ssd_scan(*args, chunk=128)
    ey, eh = ssd_tc_emulation(*args, 128)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    _close(y1, ey, 2e-2)
    _close(h1, eh, 2e-4)


@pytest.mark.cuda
def test_cuda_ssd_dtype_dispatch_and_refusals(cuda):
    """fp32 inputs take the CUDA-core kernel, bf16 the tensor-core one;
    fp16 and unaligned bf16 inputs raise."""
    g = torch.Generator(device=cuda).manual_seed(12)
    f32 = _ssd_inputs(g, 1, 64, 2, 1, 64, torch.float32, cuda)
    kernels.reset_launch_counts()
    ssd_scan(*f32, chunk=64)
    assert kernels.variant_counts()["ssd_scan.f32"] == 1
    assert kernels.variant_counts()["ssd_scan.tc"] == 0
    x, dt, A, Bm, Cm, D = f32
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), D)
    flat = torch.zeros(Bm.numel() + 1, device=cuda, dtype=torch.bfloat16)
    Bu = flat[1:].view(Bm.shape)
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan(x.bfloat16(), dt, A, Bu, Cm.bfloat16(), D)
    with pytest.raises(ValueError, match="multiple of 8"):
        ssd_scan(x.bfloat16(), dt, A, Bm[..., :12].bfloat16().contiguous(),
                 Cm[..., :12].bfloat16().contiguous(), D)
