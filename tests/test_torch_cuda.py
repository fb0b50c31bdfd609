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
(``tests/_paged_emulation.py``) at the paged tolerances.  The backward
kernels (training) are held against autograd of the plain versions, each
gradient to its dtype's tolerance of its largest |value|, and must give
the same bits twice; the tensor-core flash backward (bf16) also against
the emulation of its contract (``tests/_flash_bwd_emulation.py``) at
``BWD_EMU_TOL``; the SSD backward also against the emulation of the
fp32 kernel's algorithm (``tests/_ssd_bwd_emulation.py``) and, in bf16,
of the tensor-core kernel's contract (``tests/_ssd_bwd_tc_emulation.py``)
at ``SSD_BWD_EMU_TOL``; paged attention must raise under grad.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _flash_emulation import flash_tc_emulation               # noqa: E402
from _paged_emulation import paged_split_emulation            # noqa: E402
from _ssd_bwd_emulation import ssd_bwd_emulation              # noqa: E402
from _ssd_emulation import ssd_tc_emulation                   # noqa: E402
from repro_torch import kernels                               # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402,E501
from repro_torch.kernels.rmsnorm import rmsnorm               # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan             # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SSD_TOL = 2e-4   # fp32 SSD: the kernels sum in another order than plain
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


# the disaggregated decode tier's and the pooled path's shapes: bf16 q,
# an fp32 pool of 16-token pages, H = KV = 16, D = 64, 4 rows
DECODE_TIER_SHAPES = {
    "pooled 8-page tables": (8, [0, 17, 65, 128]),
    "disagg 15-page tables": (15, [224, 229, 235, 240]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(DECODE_TIER_SHAPES))
def test_cuda_paged_decode_tier_shapes(cuda, shape):
    """The paged kernel at the shapes the pooled path and the decode tier
    give it, against the plain version and the split-KV transcription;
    each row alone equals its row of the batch, bitwise."""
    pmax, lengths = DECODE_TIER_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(13)
    q, kp, vp, table, lens = _paged_batch(g, cuda, lengths, 16,
                                          torch.bfloat16, torch.float32,
                                          PMAX=pmax)
    got = paged_decode_attention(q, kp, vp, table, lens)
    want = ref.paged_attention_ref(q, kp, vp, table, lens)
    emu = paged_split_emulation(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    _close(got, want, TOL["bfloat16"])
    _close(got, emu, TOL["bfloat16"])
    for b in range(len(lengths)):
        alone = paged_decode_attention(q[b:b + 1].contiguous(), kp, vp,
                                       table[b:b + 1].contiguous(),
                                       lens[b:b + 1])
        torch.cuda.synchronize()
        assert torch.equal(alone[0], got[b]), b


@pytest.mark.cuda
def test_cuda_handoff_pages_and_tokens_equal_colocated(cuda):
    """A request prefilled by one engine (``prefill_export``) and handed
    to another (``submit_prefilled``) holds, in bf16 on the card, the
    same pool bytes and gives the same tokens as the same request
    prefilled and decoded by one colocated engine."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import (Engine, EngineConfig, Request,
                                   burst_trace, run_trace)

    # the smoke config with heads of 64, a head_dim both kernels take
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True),
                              head_dim=64)
    model = build_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    ecfg = EngineConfig(max_slots=4, max_seq=96, page_size=16)
    req = burst_trace(1, prompt_len=40, max_new_tokens=12,
                      vocab=model.cfg.vocab, seed=3)[0]

    colo = Engine.local(model, ecfg, params=params, device=cuda)
    colo.submit(req)
    colo._admit(0.0)
    exporter = Engine.local(model, ecfg, params=params, device=cuda)
    tok, pages, _ = exporter.prefill_export(req.prompt_tokens)
    dec = Engine.local(model, ecfg, params=params, device=cuda)
    h = dec.submit_prefilled(Request(req.prompt_tokens, req.max_new_tokens),
                             first_tok=tok, prefill_done=0.0, pages=pages,
                             page_ready=[0.0] * len(pages))
    dec._admit_handoffs(0.0)
    assert h.tokens == colo.handles[0].tokens == [tok]
    for i in range(len(pages)):
        for name in ("k", "v"):
            assert torch.equal(colo._pool[name][:, colo._table[0, i]],
                               dec._pool[name][:, dec._table[0, i]]), i
    colo.run_until_idle()
    dec.run_until_idle()
    assert h.tokens == colo.handles[0].tokens
    assert len(h.tokens) == req.max_new_tokens
    plain = run_trace(Engine.local(model, ecfg, params=params, device=cuda),
                      [req])
    assert plain[0].tokens == h.tokens


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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


@pytest.mark.cuda
def test_cuda_colocation_scenario_equals_the_cpu_run(cuda):
    """fig11's co-residency scenario (``chip_smoke.py`` phase 8's
    ``co_run``) at its racecheck shape, 4 requests a tenant and 4
    training steps, on the first 2 layers of qwen1.5-0.5b in fp32: on
    the card and on the CPU, from the same weights, each placement gives
    the same tokens, the same modeled numbers and the same trace events,
    and the card's trace is clean under the port's sanitizer."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch.analysis import diff_events, sanitize_tracer
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), n_layers=2,
                              compute_dtype="float32")
    cpu = torch.device("cpu")
    host = build_model(cfg, device=cpu)
    params = host.init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    runs = {}
    for where, dev, model, p in (("host", cpu, host, params),
                                 ("card", cuda, card,
                                  _tree_to(params, cuda))):
        bw, page_bytes = cs.co_bw(model, p, dev)
        for name, policy, train in cs.CO_RUNS:
            tracer = Tracer(1 << 18)
            r = cs.co_run(model, p, dev, policy,
                          cs.CO_RACE_STEPS if train else 0,
                          cs.co_traces(cs.CO_RACE_REQUESTS), bw,
                          tracer=tracer)
            runs[where, name] = (r, tracer, page_bytes)
    for name, _, _ in cs.CO_RUNS:
        (want, want_tr, pb), (got, got_tr, pb_card) = \
            runs["host", name], runs["card", name]
        assert pb_card == pb
        assert cs.co_outcome(got) == cs.co_outcome(want), name
        assert cs.co_modeled(got, pb) == cs.co_modeled(want, pb), name
        diff = diff_events(want_tr.events(), got_tr.events())
        assert diff.identical, diff.format()
        rep = sanitize_tracer(got_tr)
        assert rep.ok, rep.format()
    assert all(cs.co_claims({k: runs["card", k][0]
                             for k, _, _ in cs.CO_RUNS}).values())


# ---------------------------------------------------------------------------
# the moe and encdec paths (chip_smoke.py phases 9 and 4f)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 64, 1500])
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_cuda_flash_non_causal_over_1500_frames(cuda, Sq, q_dtype):
    """whisper's encoder (Sq = Skv = 1500) and cross-attention (64 and
    one query over 1500 frames): non-causal, no kv_len, H=12, D=64, bf16
    K/V, on both kernels; the tensor-core one also against its emulated
    contract."""
    g = torch.Generator(device=cuda).manual_seed(20)
    q = torch.randn(2, Sq, 12, 64, generator=g, device=cuda).to(
        getattr(torch, q_dtype))
    k, v = (torch.randn(2, 1500, 12, 64, generator=g,
                        device=cuda).bfloat16() for _ in range(2))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=False)
    variant = "tc" if q_dtype == "bfloat16" else "f32"
    assert kernels.variant_counts()[f"flash_attention.{variant}"] == 1
    with ops.plain_versions():
        want = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    _close(got, want, TOL[q_dtype])
    if variant == "tc":
        emu = flash_tc_emulation(q, k, v, causal=False)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   emu.float().cpu().numpy(), **EMU_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,window", [(16, 16, None), (32, 8, 4096)])
def test_cuda_paged_moe_decode_shapes(cuda, H, KV, window):
    """olmoe's (H=KV=16) and mixtral's (H=32, KV=8, its 4096 window)
    decode: 8 rows over bf16 pools of 64-token pages, D=128, against the
    plain version and the split-KV emulation."""
    g = torch.Generator(device=cuda).manual_seed(21)
    q, kp, vp, table, lens = _paged_batch(
        g, cuda, [120, 184, 250, 314, 500, 563, 1, 0], 64, torch.bfloat16,
        torch.bfloat16, H=H, KV=KV, D=128)
    got = paged_decode_attention(q, kp, vp, table, lens,
                                 sliding_window=window)
    want = ref.paged_attention_ref(q, kp, vp, table, lens,
                                   sliding_window=window)
    emu = paged_split_emulation(q, kp, vp, table, lens,
                                sliding_window=window)
    torch.cuda.synchronize()
    _close(got, want, TOL["bfloat16"])
    _close(got, emu, TOL["bfloat16"])
    assert torch.all(got[-1] == 0)


def _card_model(arch, **kw):
    """A smoke config widened to head_dim 64 (the kernels take 64, 112
    or 128), in fp32, built on the CPU and on the card from one draw."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_config(arch, smoke=True), d_model=256,
                              head_dim=64, compute_dtype="float32", **kw)
    host = build_model(cfg, device="cpu")
    params = host.load(host.init(torch.Generator().manual_seed(0)))
    card = build_model(cfg, device="cuda")
    return host, params, card, _tree_to(params, torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    ("olmoe-1b-7b", dict(n_heads=4, n_kv_heads=4)),
    ("mixtral-8x7b", dict(n_heads=4, n_kv_heads=2))])
def test_cuda_moe_model_equals_the_cpu_run(cuda, arch, kw):
    """The moe model on the card (fp32, TF32 off) against the same model
    on the CPU: the prefill's and a paged decode step's routing equal and
    logits within 1e-4; the expert layer gives the same bits from run to
    run (its combine has no atomics)."""
    from repro_torch.models import moe
    host, params, card, cparams = _card_model(arch, **kw)
    cfg = host.cfg
    tokens = torch.randint(1, cfg.vocab, (1, 48),
                           generator=torch.Generator().manual_seed(1))
    outs = {}
    for where, model, p in (("host", host, params), ("card", card, cparams)):
        dev = model.device
        with moe.record_routing() as calls:
            logits, cache = model.prefill_at(
                p, {"tokens": tokens.to(dev)},
                model.init_cache(1, 48, dtype=torch.float32), 40)
            pools = {n: cache[n][:, 0].reshape(cfg.n_layers, 3, 16,
                                               cfg.n_kv_heads, cfg.head_dim)
                     for n in "kv"}
            pools = {n: torch.cat([v, torch.zeros_like(v[:, :1])], 1)
                     for n, v in pools.items()}
            table = torch.arange(3, dtype=torch.int32, device=dev)[None]
            step, _ = model.decode_paged(
                p, tokens[:, 41:42].to(dev), pools, table,
                torch.tensor([41], dtype=torch.int32, device=dev))
        outs[where] = (logits.cpu(), step.cpu(),
                       [c["expert_idx"].cpu() for c in calls])
    (hl, hs, hr), (cl, cs_, cr) = outs["host"], outs["card"]
    assert all(torch.equal(a, b) for a, b in zip(hr, cr))
    _close(cl, hl, 1e-4)
    _close(cs_, hs, 1e-4)
    x = torch.randn(8, 1, cfg.d_model, device=cuda).bfloat16()
    layer = _tree_to(cparams["layers"][0]["moe"], cuda)
    layer = {k: v.bfloat16() for k, v in layer.items()}
    a, _ = moe.moe_mlp_fwd(layer, x, cfg)
    b, _ = moe.moe_mlp_fwd(layer, x, cfg)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_moe_layer_backward_gives_the_same_bits_twice(cuda, dtype):
    """The expert layer's backward on the card, with tokens dropped
    (capacity factor 0.5): two runs give the same bits in every gradient,
    x's (the dispatch's fixed-order fold, ``moe._Dispatch``), the
    router's and the experts'; x's also equals the CPU's within 1e-4 in
    fp32."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              capacity_factor=0.5, compute_dtype=dtype)
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(5)
    params = moe.init_moe_mlp(g, cfg, dt, "cpu")
    x = torch.randn(4, 64, cfg.d_model, generator=g).to(dt)
    dy = torch.randn(4, 64, cfg.d_model, generator=g).to(dt)
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        p = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        xx = x.to(dev).requires_grad_(True)
        y, aux = moe.moe_mlp_fwd(p, xx, cfg, groups=2)
        torch.autograd.backward((y, aux), (dy.to(dev), torch.ones_like(aux)))
        runs.append([xx.grad.cpu()] + [p[k].grad.cpu() for k in sorted(p)])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    if dtype == "float32":
        _close(runs[0][0], runs[2][0], 1e-4)


@pytest.mark.cuda
def test_cuda_encdec_model_equals_the_cpu_run(cuda):
    """whisper smoke widened to head_dim 64, fp32: the prefill (encoder,
    decoder, cross-attention) and a decode step on the card against the
    CPU within 1e-4, every attention through the flash kernel."""
    host, params, card, cparams = _card_model(
        "whisper-small", n_heads=4, n_kv_heads=4, enc_seq=96)
    cfg = host.cfg
    g = torch.Generator().manual_seed(2)
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=g)
    tokens = torch.randint(1, cfg.vocab, (2, 12), generator=g)
    outs = {}
    for where, model, p in (("host", host, params), ("card", card, cparams)):
        dev = model.device
        kernels.reset_launch_counts()
        logits, cache, enc = model.prefill(
            p, {"frame_embeds": frames.to(dev), "tokens": tokens.to(dev)},
            model.init_cache(2, 16, dtype=torch.float32))
        step, _ = model.decode(p, tokens[:, :1].to(dev), cache, 12, enc)
        n = kernels.launch_counts()["flash_attention"]
        outs[where] = (logits.cpu(), step.cpu(), enc.cpu(), n)
    assert outs["host"][3] == 0
    assert outs["card"][3] == cfg.n_enc_layers + 4 * cfg.n_layers
    for got, want in zip(outs["card"][:3], outs["host"][:3]):
        _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# the backward kernels (training): against autograd of the plain versions
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, KV, D, dtype, causal, window, q_offset, kv_len); olmo's
# case is olmoe's shape too (16 heads of 128, causal)
FLASH_BWD_CASES = [
    (2, 512, 512, 16, 16, 128, "bfloat16", True, None, 0, None),  # olmo
    (2, 512, 512, 16, 16, 64, "bfloat16", True, None, 0, None),   # qwen
    (2, 300, 300, 32, 8, 128, "bfloat16", True, 128, 0, None),    # GQA
    (2, 64, 300, 8, 8, 64, "bfloat16", False, None, 0, None),
    # whisper's encoder (1500 frames: a ragged 28-key tail), its
    # cross-attention and its decoder's self-attention
    (2, 1500, 1500, 12, 12, 64, "bfloat16", False, None, 0, None),
    (2, 448, 1500, 12, 12, 64, "bfloat16", False, None, 0, None),
    (2, 448, 448, 12, 12, 64, "bfloat16", True, None, 0, None),
    # zamba2's shared attention block: head_dim 112
    (2, 512, 512, 32, 32, 112, "bfloat16", True, None, 0, None),
    (2, 300, 300, 8, 2, 112, "float32", True, None, 0, None),
    (2, 300, 300, 8, 2, 64, "float32", True, 100, 0, None),
    (2, 70, 96, 8, 2, 128, "float32", True, 24, 10, 80),
    (2, 70, 96, 8, 2, 64, "float32", True, 8, 0, 13),   # rows see no key
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_cuda_flash_backward_matches_autograd_of_plain(cuda, case):
    """dq, dk, dv of the backward kernel against autograd through
    ``ref.attention_ref`` in fp32, each to its dtype's tolerance of the
    largest |grad|; two runs give the same bits; one backward launch."""
    B, Sq, Skv, H, KV, D, dtype, causal, window, off, kv_len = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(B, Skv, KV, D, generator=g, device=cuda).to(dt)
            for _ in range(2))
    do = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dt)
    kw = dict(causal=causal, sliding_window=window, q_offset=off,
              kv_len=kv_len)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        kernels.reset_launch_counts()
        flash_attention(*leaves, **kw).backward(do)
        assert kernels.backward_counts()["flash_attention_bwd"] == 1
        runs.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    plain = [t.float().requires_grad_(True) for t in (q, k, v)]
    with ops.plain_versions():
        ops.flash_attention(*plain, **kw).backward(do.float())
    for got, want in zip(runs[0], plain):
        scale = float(want.grad.abs().max())
        err = float((got.float() - want.grad).abs().max())
        assert err <= TOL[dtype] * scale, (err, scale)
    if window == 8:     # rows 20.. of that case see no key
        assert (runs[0][0][:, 20:] == 0).all()


# the tensor-core backward (bf16) against the emulation of its contract
# (tests/_flash_bwd_emulation.py) on the kernel's own forward output and
# log-sum-exp: one bf16 ulp (rtol 2^-7) for a rounding flip of a
# gradient, plus 2e-3 of the largest |grad| (ten times under the 2e-2
# the plain version is held to) for fp32 sums taken in another order and
# the rare P or dS rounding flip they cause
BWD_EMU_TOL = {"atol_of_max": 2e-3, "rtol": 2 ** -7}
FLASH_BWD_TC_CASES = [c for c in FLASH_BWD_CASES if c[6] == "bfloat16"] + [
    (2, 200, 200, 16, 16, 128, "bfloat16", True, None, 0, None),  # Sq 200
    (1, 130, 300, 16, 4, 64, "bfloat16", True, 64, 170, 290),      # G=4
    (1, 7, 33, 4, 2, 64, "bfloat16", True, None, 26, None),        # Sq 7
    (2, 70, 96, 8, 2, 128, "bfloat16", True, 8, 0, 13),  # rows see no key
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BWD_TC_CASES)
def test_cuda_flash_backward_tc_matches_emulation(cuda, case):
    """Every bf16 backward takes the tensor-core kernel (one backward
    call, on the ``tc`` variant), gives the same bits twice, and matches
    the emulation of its contract at ``BWD_EMU_TOL``."""
    from _flash_bwd_emulation import flash_bwd_tc_emulation
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, KV, D, dtype, causal, window, off, kv_len = case
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, Skv, KV, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    do = torch.randn(B, Sq, H, D, generator=g, device=cuda).bfloat16()
    kw = dict(causal=causal, sliding_window=window, q_offset=off,
              kv_len=kv_len)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        kernels.reset_launch_counts()
        flash_attention(*leaves, **kw).backward(do)
        assert kernels.backward_counts()["flash_attention_bwd"] == 1
        assert kernels.backward_variant_counts() == {
            "flash_attention_bwd.tc": 1, "flash_attention_bwd.f32": 0,
            "ssd_scan_bwd.tc": 0, "ssd_scan_bwd.f32": 0}
        runs.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=cuda)
    out = fa._launch_forward(q, k, v, causal, window, 1.0 / D ** 0.5, off,
                             Skv if kv_len is None else kv_len, lse)
    want = flash_bwd_tc_emulation(q, k, v, do, **kw, out=out, lse=lse)
    for got, w in zip(runs[0], want):
        got, w = got.float(), w.float()
        limit = (BWD_EMU_TOL["atol_of_max"] * float(w.abs().max())
                 + BWD_EMU_TOL["rtol"] * w.abs())
        assert bool(((got - w).abs() <= limit).all()), \
            float((got - w).abs().max())
    if window == 8:     # rows 20.. see no key, keys 13.. no row
        assert (runs[0][0][:, 20:] == 0).all()
        assert (runs[0][1][:, 13:] == 0).all()
        assert (runs[0][2][:, 13:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype,offset", [
    (4096, 1024, "bfloat16", 0), (4096, 1024, "float32", 0),
    (8, 2048, "bfloat16", 0), (33, 1001, "float32", 0),
    (3000, 64, "bfloat16", 0), (2, 16384, "float32", 0),
    (4096, 1024, "bfloat16", 1), (300, 1024, "float32", 3),
    (64, 1536, "bfloat16", 1), (500, 1032, "bfloat16", 0)] + [
    # the block-per-row branch at mamba2's 1536 and 3072, olmoe's 2048,
    # zamba2's 3584 and 7168 and MAX_D: 4095 rows leave the last block
    # short, an offset of 1 takes the scalar loads
    (rows, d, "bfloat16", offset) for d in (1536, 2048, 3072, 3584, 7168,
                                            16384)
    for rows, offset in ((4095, 0), (999, 1))])
def test_cuda_rmsnorm_backward_matches_autograd_of_plain(cuda, rows, d,
                                                         dtype, offset):
    """``offset`` > 0 starts x and dy that many elements into their
    buffers: contiguous views whose rows do not start on 16-byte
    boundaries (each branch's scalar loads).  Rows wider than
    ``BWD_WARP_MAX_D`` (1024) take the block-per-row branch."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    xb = torch.randn(offset + rows * d, generator=g, device=cuda).to(dt)
    s = (1 + 0.1 * torch.randn(d, generator=g, device=cuda)).to(dt)
    dyb = torch.randn(offset + rows * d, generator=g, device=cuda).to(dt)
    dy = dyb[offset:].view(rows, d)
    assert (dy.data_ptr() % 16 != 0) == (offset > 0)
    runs = []
    for _ in range(2):
        xb_ = xb.clone().requires_grad_(True)
        ss = s.clone().requires_grad_(True)
        kernels.reset_launch_counts()
        rmsnorm(xb_[offset:].view(rows, d), ss).backward(dy)
        assert kernels.backward_counts()["rmsnorm_bwd"] == 1
        runs.append((xb_.grad[offset:].view(rows, d), ss.grad))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    xx = xb[offset:].view(rows, d).clone().requires_grad_(True)
    ss = s.clone().requires_grad_(True)
    ref.rmsnorm_ref(xx, ss).backward(dy)
    for got, want in zip(runs[0], (xx.grad, ss.grad)):
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= \
            TOL[dtype] * scale


@pytest.mark.cuda
def test_cuda_kernels_without_backward_raise_under_grad(cuda):
    """Paged decode attention has no backward kernel: asked for a
    gradient, it raises instead of returning a result cut off from the
    graph; under ``torch.no_grad()`` it runs.  The SSD scan, once refused
    here too, now differentiates through its backward kernel (one B8
    launch, checked below)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, 4, 64, generator=g, device=cuda, requires_grad=True)
    kp = torch.randn(5, 16, 4, 64, generator=g, device=cuda)
    table = torch.arange(4, dtype=torch.int32, device=cuda).reshape(2, 2)
    lens = torch.tensor([20, 7], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="backward"):
        paged_decode_attention(q, kp, kp, table, lens)
    with torch.no_grad():
        paged_decode_attention(q, kp, kp, table, lens)
    x = torch.randn(1, 64, 2, 64, generator=g, device=cuda,
                    requires_grad=True)
    args = (torch.rand(1, 64, 2, device=cuda), -torch.rand(2, device=cuda),
            torch.randn(1, 64, 1, 64, device=cuda),
            torch.randn(1, 64, 1, 64, device=cuda), torch.ones(2, device=cuda))
    kernels.reset_launch_counts()
    ssd_scan(x, *args, chunk=64)[0].sum().backward()
    assert kernels.backward_counts()["ssd_scan_bwd"] == 1
    assert bool(torch.isfinite(x.grad).all())


# (B, S, H, P, G, N, chunk, dtype, init): mamba2's training shape cut to
# B=2, zamba2's (N=64, H=112), a ragged S with G=2 and an initial state
# whose final state has a gradient, P=32, a chunk under 64
SSD_BWD_CASES = [
    (2, 512, 48, 64, 1, 128, 128, "bfloat16", False),
    (2, 512, 112, 64, 1, 64, 128, "bfloat16", False),
    (2, 300, 8, 64, 2, 64, 128, "bfloat16", True),
    (2, 300, 8, 64, 2, 128, 128, "float32", True),
    (2, 100, 4, 32, 1, 16, 128, "float32", False),
    (1, 70, 4, 64, 2, 128, 32, "bfloat16", True),
]
# the backward kernel against the emulation of its algorithm: both fp32
# throughout, sums in other orders (``SSD_TOL`` of the largest |grad|),
# and dx, dB, dC rounded to bf16 once (one bf16 ulp: rtol 2^-7)
SSD_BWD_EMU_TOL = {"atol_of_max": SSD_TOL, "rtol": 2 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_cuda_ssd_backward_matches_autograd_of_plain(cuda, case):
    """dx, ddt, dA, dB, dC, dD (and dh0) of the SSD backward kernel
    against autograd through ``ref.ssd_chunked_ref``, each to its dtype's
    tolerance of the largest |grad| (fp32 ``SSD_TOL``: the sums run in
    another order), and against the emulation; two runs give the same
    bits; one forward and one backward launch."""
    B, S, H, P, G, N, chunk, dtype, init = case
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(5)
    args = _ssd_inputs(g, B, S, H, G, N, dt_, cuda, P=P)
    h0 = torch.randn(B, H, P, N, generator=g, device=cuda) if init else None
    dy = torch.randn(B, S, H, P, generator=g, device=cuda).to(dt_)
    dst = torch.randn(B, H, P, N, generator=g, device=cuda) if init else None
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in args] + (
            [h0.clone().requires_grad_(True)] if init else [])
        kernels.reset_launch_counts()
        y, st = ssd_scan(*leaves[:6], chunk=chunk,
                         init_state=leaves[6] if init else None)
        torch.autograd.backward([y] + ([st] if init else []),
                                [dy] + ([dst] if init else []))
        assert kernels.backward_counts()["ssd_scan_bwd"] == 1
        assert kernels.backward_variant_counts()[
            "ssd_scan_bwd." + ("tc" if dtype == "bfloat16" else "f32")] == 1
        assert kernels.launch_counts()["ssd_scan"] == 1
        runs.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    plain = [t.clone().requires_grad_(True) for t in args] + (
        [h0.clone().requires_grad_(True)] if init else [])
    y, st = ref.ssd_chunked_ref(*plain[:6], chunk,
                                init_state=plain[6] if init else None)
    torch.autograd.backward([y] + ([st] if init else []),
                            [dy] + ([dst] if init else []))
    tol = SSD_TOL if dtype == "float32" else TOL[dtype]
    for got, want in zip(runs[0], plain):
        scale = float(want.grad.float().abs().max())
        err = float((got.float() - want.grad.float()).abs().max())
        assert err <= tol * scale, (err, scale)
    emu = ssd_bwd_emulation(*args, dy, chunk=chunk, init_state=h0,
                            dstate=dst)
    for got, want in zip(runs[0], emu):
        got, want = got.float(), want.float()
        limit = (SSD_BWD_EMU_TOL["atol_of_max"] * float(want.abs().max())
                 + SSD_BWD_EMU_TOL["rtol"] * want.abs())
        assert bool(((got - want).abs() <= limit).all()), \
            float((got - want).abs().max())


# (case, run): every bf16 case above at the wrapper's run length, then
# P=32 and zamba2's H=112 with runs of 3 (which 112 leaves a run of 1)
SSD_BWD_TC_CASES = [(c, None) for c in SSD_BWD_CASES
                    if c[7] == "bfloat16"] + [
    ((2, 300, 8, 32, 2, 64, 128, "bfloat16", True), None),
    ((2, 512, 112, 64, 1, 64, 128, "bfloat16", True), 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,run", SSD_BWD_TC_CASES)
def test_cuda_ssd_backward_tc_matches_emulation(cuda, case, run):
    """The bf16 SSD backward on its tensor-core kernel
    (``ssd_scan_bwd_tc.cu``, one call on ``ssd_scan_bwd.tc``) against the
    emulation of its contract (``tests/_ssd_bwd_tc_emulation.py``) at
    ``SSD_BWD_EMU_TOL``: 2e-4 of the largest |grad| for fp32 sums in
    other orders plus one bf16 ulp of dx, dB and dC; the same bits
    twice."""
    from _ssd_bwd_tc_emulation import ssd_bwd_tc_emulation
    from repro_torch.kernels import ssd_scan as ssd
    B, S, H, P, G, N, chunk, dtype, init = case
    g = torch.Generator(device=cuda).manual_seed(7)
    args = _ssd_inputs(g, B, S, H, G, N, torch.bfloat16, cuda, P=P)
    h0 = torch.randn(B, H, P, N, generator=g, device=cuda) if init else None
    dy = torch.randn(B, S, H, P, generator=g, device=cuda).to(torch.bfloat16)
    dst = torch.randn(B, H, P, N, generator=g, device=cuda) if init else None
    Q = min(chunk, S)
    runs = []
    for _ in range(2):
        kernels.reset_launch_counts()
        runs.append(ssd._launch_backward(*args, h0, dy, dst, Q, run=run))
        assert kernels.backward_counts()["ssd_scan_bwd"] == 1
        assert kernels.backward_variant_counts()["ssd_scan_bwd.tc"] == 1
    torch.cuda.synchronize()
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(*runs))
    emu = ssd_bwd_tc_emulation(
        *args, dy, chunk=chunk, init_state=h0, dstate=dst,
        run=ssd.bwd_run(B, S, H, G, Q) if run is None else run)
    for got, want in zip(runs[0], emu):
        if want is None:
            assert got is None
            continue
        got, want = got.float(), want.float()
        limit = (SSD_BWD_EMU_TOL["atol_of_max"] * float(want.abs().max())
                 + SSD_BWD_EMU_TOL["rtol"] * want.abs())
        assert bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= limit).all()), \
            float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_of_an_empty_sequence(cuda, dtype):
    """S = 0 launches nothing: y is empty and the final state is the
    initial one (zeros without it); differentiated, the initial state's
    gradient is the final state's and every other gradient is zero."""
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(6)
    args = _ssd_inputs(g, 2, 0, 4, 1, 64, dt_, cuda)
    h0 = torch.randn(2, 4, 64, 64, generator=g, device=cuda)
    kernels.reset_launch_counts()
    with torch.no_grad():
        y, st = ssd_scan(*args, chunk=128)
    assert y.shape == (2, 0, 4, 64) and torch.equal(st, torch.zeros_like(h0))
    leaves = [t.clone().requires_grad_(True) for t in args + (h0,)]
    y, st = ssd_scan(*leaves[:6], chunk=128, init_state=leaves[6])
    assert y.shape == (2, 0, 4, 64) and torch.equal(st, h0)
    dst = torch.randn(2, 4, 64, 64, generator=g, device=cuda)
    torch.autograd.backward([y, st], [torch.zeros_like(y), dst])
    assert torch.equal(leaves[6].grad, dst)
    assert all(not t.grad.any() for t in leaves[:6])
    assert not any(kernels.launch_counts().values())
    assert not any(kernels.backward_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmo-1b"])
def test_cuda_model_grads_equal_the_plain_path(cuda, arch):
    """A small dense model at head_dim 64 in fp32: the loss and every
    gradient leaf through the kernels (flash, RMSNorm and their
    backwards, remat on) equal the plain path's to 1e-5 of the leaf's
    largest |g|, and every leaf gets a non-zero gradient."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch, smoke=True), d_model=128,
                              n_heads=2, n_kv_heads=2, head_dim=64,
                              d_ff=256, compute_dtype="float32")
    model = build_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 96), generator=g,
                              device=cuda) for k in ("tokens", "labels")}
    out = []
    for plain in (False, True):
        live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                        params)
        leaves = tree_leaves(live)
        kernels.reset_launch_counts()
        if plain:
            with ops.plain_versions():
                loss = model.loss(live, batch, remat=True)
                loss.backward()
        else:
            loss = model.loss(live, batch, remat=True)
            loss.backward()
            assert kernels.backward_counts()["flash_attention_bwd"] == \
                cfg.n_layers
        out.append((float(loss.detach()), [t.grad for t in leaves]))
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    for got, want in zip(out[0][1], out[1][1]):
        assert float(got.abs().max()) > 0
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
