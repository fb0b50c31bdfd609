"""The collectives inside the model under tensor parallelism
(``repro_torch.sharding.tp``) on a 2-rank ``model`` world over gloo
(``tests/_dist_world.py``), each piece held forward and backward
against the one-process computation on the same inputs in fp32 within
1e-6 relative (of the largest |value| of each tensor): the Megatron
column -> row MLP, attention on each rank's local heads (GQA, qkv bias,
qk-norm scales whose gradient is summed over the group), the
vocab-parallel embedding lookup, and the vocab-parallel cross entropy
over a vocab of 250 padded to 256 (the rank holding the padded rows
leaves them out of the log-sum-exp), with and without a mask.  The
gradients of sharded leaves are this rank's block of the one-process
gradient.  Also the placement helpers of ``sharding.partition``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import load, run_world                       # noqa: E402

from repro_torch.launch.mesh import Layout                    # noqa: E402
from repro_torch.sharding import partition                    # noqa: E402

PIECES = ("mlp", "attention", "embedding", "cross_entropy",
          "cross_entropy_mask")
REL = 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_pieces")
    run_world(2, "tp_pieces", d)
    return [load(d, "tp_pieces", r) for r in range(2)]


@pytest.mark.parametrize("piece", PIECES)
def test_piece_matches_the_one_process_computation(ranks, piece):
    for rank in ranks:
        for name, got, want in rank[piece]:
            assert got.shape == want.shape, (piece, name)
            top = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= REL * max(top, 1e-30), (piece, name, err, top)


def test_the_collectives_that_ran(ranks):
    """Forward all-reduces after the row-parallel MLP, attention and the
    lookup, and three in the loss per call (max, sum, gold); backward
    all-reduces of copy_to_model's inputs and of the qk-norm scales."""
    calls = ranks[0]["stats"]
    assert set(calls) == {"model:all-reduce"}
    # mlp 1 + 1, attention 1 + 1 + 2 norms, embedding 1, loss 2 x (3 + 1)
    assert calls["model:all-reduce"] == 2 + 4 + 1 + 8
    assert ranks[1]["stats"] == calls


def test_blocks_slice_gather_and_index():
    """``Block`` per rank of a (data 2, model 2) layout: the FSDP and
    model split of ``wq``, the replica-zero rule and the manifest
    index the reference writes."""
    layout = Layout((2, 2), ("data", "model"))
    rules = partition.Rules({"embed": "data", "qkv_out": "model",
                             "embed_norm": None})
    full = torch.arange(64 * 64.0).reshape(64, 64)
    parts = {}
    for r in range(4):
        c = layout.coords(r)
        b = partition.block_of(layout, c, rules, ("embed", "qkv_out"))
        assert b.axes == (("data",), ("model",))
        assert partition.replica_zero(b, c)
        parts[(c["data"], c["model"])] = partition.shard_leaf(full, b)
        assert b.index((64, 64)) == [[32 * c["data"], 32 * c["data"] + 32,
                                      None],
                                     [32 * c["model"], 32 * c["model"] + 32,
                                      None]]
        n = partition.block_of(layout, c, rules, ("embed_norm",))
        assert n.whole and n.index((64,)) == [[None, None, None]]
        assert partition.replica_zero(n, c) == (r == 0)
    again = torch.cat([torch.cat([parts[(i, j)] for j in range(2)], 1)
                       for i in range(2)], 0)
    assert torch.equal(again, full)
    assert dict(partition.named_axes(
        {"a": [{"w": ("embed",)}, {"w": ("embed",)}], "b": {}})) == {
            "a/w": ("embed",)}
