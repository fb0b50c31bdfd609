"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test skips (a CUDA kernel
has no CPU mode; the plain versions are held against the reference in
``tests/test_torch_kernels.py``).  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: 1e-5 in fp32, 2e-2 when q is bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402,E501
from repro_torch.kernels.rmsnorm import rmsnorm               # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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
@pytest.mark.parametrize("D", [64, 128])
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
@pytest.mark.parametrize("rows", [1, 7, 300])
@pytest.mark.parametrize("d", [64, 1024])
def test_cuda_rmsnorm_kernel_matches_plain(cuda, rows, d):
    x = torch.randn(rows, d, device=cuda).bfloat16()
    s = 1 + 0.1 * torch.randn(d, device=cuda)
    got = rmsnorm(x, s)
    want = ref.rmsnorm_ref(x, s)
    torch.cuda.synchronize()
    _close(got, want, 2e-2)
