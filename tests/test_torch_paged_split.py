"""The split-KV paged decode kernel's algorithm, on the CPU.

``tests/_paged_emulation.py`` transcribes the algorithm of
``src/repro_torch/csrc/paged_attention.cu``: splits of 64 logical
positions, per-split (m, l, acc) in fp32, and a combine in split order.
Here it is held against the JAX package's Pallas kernel
``repro.kernels.paged_attention.paged_decode_attention`` (in interpret
mode, as ``tests/test_paged_attention.py`` runs it) and against the
port's plain path, on the same numpy inputs: page sizes 16 and 64, GQA
groups 1 and 4, with and without a sliding window, lengths 0, 1, a page
boundary, a page boundary + 1, a split boundary + 2 and a full table.
Tolerances are the reference suite's: 1e-5 in fp32, 2e-2 with bf16 q
(an fp32 pool, as the engine decodes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from _paged_emulation import live_splits, paged_split_emulation  # noqa: E402
from repro.kernels.paged_attention import paged_decode_attention as pallas_paged  # noqa: E402,E501
from repro_torch.kernels.paged_attention import paged_decode_attention  # noqa: E402,E501

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
KV, D, PMAX_TOKENS = 2, 64, 256


def _case(seed, ps, G, q_dtype, lengths=None):
    """(jnp, torch) pairs of q, pool, table and lengths: each row on its
    own shuffled pages, the table's tail on a trash page."""
    rng = np.random.RandomState(seed)
    PMAX = PMAX_TOKENS // ps
    if lengths is None:
        lengths = [0, 1, ps, ps + 1, 130, PMAX * ps]
    B = len(lengths)
    P = B * PMAX + 1
    q = rng.standard_normal((B, KV * G, D))
    kp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    table = rng.permutation(P - 1)[:B * PMAX].reshape(B, PMAX)
    for b, n in enumerate(lengths):
        table[b, -(-n // ps):] = P - 1                    # the trash page
    table = table.astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    jq = jnp.asarray(q, getattr(jnp, q_dtype))
    tq = torch.as_tensor(np.array(jq.astype(jnp.float32))).to(
        getattr(torch, q_dtype))
    return ((jq, tq), (jnp.asarray(kp), torch.as_tensor(kp)),
            (jnp.asarray(vp), torch.as_tensor(vp)),
            (jnp.asarray(table), torch.as_tensor(table)),
            (jnp.asarray(lens), torch.as_tensor(lens)))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("ps", [16, 64])
def test_split_emulation_matches_pallas_kernel(ps, G, window, q_dtype):
    args = _case(0, ps, G, q_dtype)
    want = pallas_paged(*(j for j, _ in args), sliding_window=window)
    got = paged_split_emulation(*(t for _, t in args),
                                sliding_window=window)
    assert got.dtype == getattr(torch, q_dtype)
    _close(got.float(), want.astype(jnp.float32), TOL[q_dtype],
           f"ps={ps} G={G} window={window} q={q_dtype}")
    assert torch.all(got[0] == 0), "a length-0 row is not exactly zero"


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("ps", [16, 64])
def test_split_emulation_matches_port_plain_path(ps, window):
    """The port's CPU path (the plain version the card holds the kernel
    against) agrees with the split algorithm."""
    args = [t for _, t in _case(1, ps, 4, "float32")]
    _close(paged_split_emulation(*args, sliding_window=window),
           paged_decode_attention(*args, sliding_window=window), 1e-5,
           f"ps={ps} window={window}")


def test_split_emulation_layout_invariance_bitwise():
    """The same logical K/V on another physical layout (pages permuted,
    the table remapped) gives bitwise the same output."""
    q, kp, vp, table, lens = (t for _, t in _case(2, 16, 4, "float32"))
    perm = torch.as_tensor(np.random.RandomState(3).permutation(kp.shape[0]))
    kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
    kp2[perm], vp2[perm] = kp, vp
    table2 = perm[table.long()].to(torch.int32)
    for window in (None, 40):
        assert torch.equal(
            paged_split_emulation(q, kp, vp, table, lens,
                                  sliding_window=window),
            paged_split_emulation(q, kp2, vp2, table2, lens,
                                  sliding_window=window))


def test_split_count_and_row_output_do_not_change_with_the_batch():
    """A row's splits depend on its own length, window and the split
    size only; decoded alone (B = 1, another table width) or inside B = 8
    it gives bitwise the same output."""
    lengths = [250, 0, 1, 64, 65, 129, 200, 256]
    q, kp, vp, table, lens = (t for _, t in _case(4, 16, 1, "bfloat16",
                                                  lengths))
    for window in (None, 40):
        full = paged_split_emulation(q, kp, vp, table, lens,
                                     sliding_window=window)
        for b, n in enumerate(lengths):
            n_pages = max(1, -(-n // 16))
            alone = paged_split_emulation(
                q[b:b + 1], kp, vp, table[b:b + 1, :n_pages].contiguous(),
                lens[b:b + 1], sliding_window=window)
            assert torch.equal(alone[0], full[b]), (b, window)
            assert (live_splits(n, window, capacity=n_pages * 16)
                    == live_splits(n, window, capacity=256))
    assert list(live_splits(300, None)) == [0, 1, 2, 3, 4]
    assert list(live_splits(300, 40)) == [4]
    assert list(live_splits(200, 80)) == [1, 2, 3]
    assert list(live_splits(0, 40)) == []
