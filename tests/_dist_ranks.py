"""What each rank of a CPU world runs for the distributed tests
(``tests/_dist_world.py`` starts them).  Torch, numpy and the port
only: the reference's numbers are computed in the test process.

Every function reads its rank from the environment, joins the grid over
the ``file://`` store in ``DIST_INIT``, and writes its findings with
``torch.save`` to ``<out_dir>/<name>.r<rank>.pt``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import elastic
from repro_torch.configs import get_config
from repro_torch.core import hierarchy as h
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.runtime import train
from repro_torch.sharding.profiles import make_rules
from repro_torch.tree import tree_leaves, tree_map

POD_GRID = ((2, 2, 1), ("pod", "data", "model"))
MODES = {"auto": ("auto", False), "hierarchical": ("hierarchical", False),
         "compress_pod": ("hierarchical", True)}
LR = 1e-3


def _grid(shape, axes) -> mesh_lib.RankGrid:
    return mesh_lib.init_grid(
        mesh_lib.Layout(tuple(shape), tuple(axes)),
        rank=int(os.environ["RANK"]), device=torch.device("cpu"),
        init_method=os.environ["DIST_INIT"], timeout_s=100)


def _save(out_dir, name, rank, obj) -> None:
    torch.save(obj, Path(out_dir) / f"{name}.r{rank}.pt")


def hierarchy(out_dir, seed: int = 0):
    """The collectives on a (pod 2, data 2, model 1) grid: flat and
    hierarchical all-reduce of each rank's rows, the compressed mean of
    each pod's vector with its residual, 20 error-feedback steps, the
    byte counter under the three gradient schedules, and all-reduces on
    both sides of ``EXCHANGE_BYTES``."""
    grid = _grid(*POD_GRID)
    r, out = grid.rank, {}
    x = torch.arange(32.0).reshape(8, 4)[2 * r:2 * r + 2]
    out["flat"] = h.flat_allreduce(x, grid, ("pod", "data"))
    out["hier"] = h.hierarchical_allreduce(x, grid, intra_axis="data",
                                           inter_axis="pod")
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((2, 3, 64)).astype(np.float32)
    rs = (0.01 * rng.standard_normal((2, 3, 64))).astype(np.float32)
    pod = grid.coords["pod"]
    x_pod = torch.from_numpy(xs[pod])
    out["compressed"] = h.compressed_cross_pod_mean(
        x_pod, grid, torch.from_numpy(rs[pod]))
    out["quant"] = h.quantize_int8(torch.from_numpy(xs[0]))
    res, acc = torch.zeros(3, 64), torch.zeros(3, 64)
    for _ in range(20):
        o, res = h.compressed_cross_pod_mean(x_pod, grid, res)
        acc += o
    out["ef_avg"] = acc / 20
    g = {"w": torch.zeros(1024, 64)}
    for name, fn in (
            ("flat", lambda: h.reduce_gradients_flat(g, grid)),
            ("hierarchical", lambda: h.reduce_gradients_hierarchically(
                g, grid)),
            ("compress_pod", lambda: h.reduce_gradients_hierarchically(
                g, grid, compress=True))):
        grid.stats.reset()
        fn()
        out[f"bytes_{name}"] = dict(grid.stats.moved_bytes)
        out[f"pod_bytes_{name}"] = grid.stats.axis_bytes("pod")
    # all-reduces at the exchange's bound and one element over (gloo's
    # ring), of each rank's seeded fp32 vector
    for name, n in (("exchange", h.EXCHANGE_BYTES // 4),
                    ("ring", h.EXCHANGE_BYTES // 4 + 1)):
        v = torch.from_numpy(np.random.default_rng(seed + r).standard_normal(
            n).astype(np.float32))
        for op in ("sum", "max"):
            out[f"{name}_{op}"] = h.all_reduce(v.clone(), grid,
                                               ("pod", "data"), op=op)
    _save(out_dir, "hierarchy", r, out)
    grid.close()


def _setup(out_dir, arch, compute):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    model = build_model(cfg, device="cpu")
    data = np.load(Path(out_dir) / "inputs.npz")
    with open(Path(out_dir) / "params.pkl", "rb") as f:
        params = bridge.params_from_reference(pickle.load(f), "cpu")
    return model, params, _batches(data)


def _batches(data):
    """Each step's batch of ``inputs.npz``, with its frame embeddings
    (``frames``, encdec) where it has them."""
    out = []
    for k in range(data["tokens"].shape[0]):
        b = {"tokens": data["tokens"][k], "labels": data["labels"][k]}
        if "frames" in data:
            b["frame_embeds"] = data["frames"][k]
        out.append(b)
    return out


def _clone(state):
    return tree_map(torch.clone, state)


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def train_modes(out_dir, arch: str, compute: str, steps: int = 3):
    """3 steps of each mode on the (pod 2, data 2, model 1) grid from the
    reference's initial parameters (``inputs.npz``), each mode's first
    step run twice in bits; on rank 0 also 3 steps of the one-process
    step on the global batches."""
    grid = _grid(*POD_GRID)
    model, params, batches = _setup(out_dir, arch, compute)
    opt = AdamW(lr=LR)
    B, S = batches[0]["tokens"].shape
    shape = ShapeConfig("t", "train", S, B)
    out = {}
    for name, (mode, compress) in MODES.items():
        tcfg = train.TrainStepConfig(dp_mode=mode, compress_pod=compress)
        rules = make_rules(model.cfg, shape, grid, fsdp=False, dp_mode=mode)
        step = train.make_train_step(model, opt, shape, mesh=grid,
                                     rules=rules, tcfg=tcfg)
        state = train.state_from_params(_clone(params), opt, tcfg, mesh=grid)
        first, m1 = step(state, batches[0])
        again, m2 = step(state, batches[0])
        twice = _same_bits(first, again) and all(
            torch.equal(m1[k], m2[k]) for k in m1)
        metrics, state = [], first
        metrics.append({k: float(v) for k, v in m1.items()})
        for b in batches[1:steps]:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": metrics, "twice": twice,
                     "params": bridge.params_to_reference(state.params),
                     "residual1": first.residuals.get("g") if compress
                     else None}
    if grid.rank == 0:
        tcfg = train.TrainStepConfig()
        step = train.make_train_step(model, opt, shape, tcfg=tcfg)
        state = train.state_from_params(_clone(params), opt, tcfg)
        metrics = []
        for b in batches[:steps]:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out["one_process"] = {
            "metrics": metrics,
            "params": bridge.params_to_reference(state.params)}
    _save(out_dir, f"train_{arch}_{compute}", grid.rank, out)
    grid.close()


def _ckpt_tree(state):
    return {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu}


def replan_write(out_dir, arch: str = "olmo-1b"):
    """fp32 ``auto`` on the (pod 2, data 2, model 1) grid: 2 steps, rank 0
    checkpoints, then a third step (the uninterrupted run)."""
    grid = _grid(*POD_GRID)
    model, params, batches = _setup(out_dir, arch, "float32")
    opt = AdamW(lr=LR)
    B, S = batches[0]["tokens"].shape
    shape = ShapeConfig("t", "train", S, B)
    step = train.make_train_step(
        model, opt, shape, mesh=grid,
        rules=make_rules(model.cfg, shape, grid, fsdp=False))
    state = train.state_from_params(params, opt)
    for b in batches[:2]:
        state, _ = step(state, b)
    if grid.rank == 0:
        ckpt.save(Path(out_dir) / "ckpt", _ckpt_tree(state), step=2).wait()
    at2 = _ckpt_tree(state)
    state, m = step(state, batches[2])
    _save(out_dir, "replan_write", grid.rank, {
        "at2": at2, "params3": state.params,
        "metrics3": {k: float(v) for k, v in m.items()}})
    grid.close()


def replan_read(out_dir, arch: str = "olmo-1b"):
    """``replan`` of the 4-rank checkpoint onto this world's grid (data
    parallel over every rank), then the third step."""
    world = int(os.environ["WORLD_SIZE"])
    grid = _grid((world, 1), ("data", "model"))
    model, params, batches = _setup(out_dir, arch, "float32")
    opt = AdamW(lr=LR)
    B, S = batches[0]["tokens"].shape
    shape = ShapeConfig("t", "train", S, B)
    rules = make_rules(model.cfg, shape, grid, fsdp=False)
    template = _ckpt_tree(train.state_from_params(params, opt))
    tree, extra = elastic.replan(Path(out_dir) / "ckpt", template, grid,
                                 rules)
    state = train.TrainState(tree["params"], AdamWState(
        torch.tensor(extra["step"], dtype=torch.int32), tree["mu"],
        tree["nu"]), {})
    step = train.make_train_step(model, opt, shape, mesh=grid, rules=rules)
    new, m = step(state, batches[2])
    _save(out_dir, f"replan_read{world}", grid.rank, {
        "restored": tree, "step": extra["step"], "params3": new.params,
        "metrics3": {k: float(v) for k, v in m.items()}})
    grid.close()


# ---------------------------------------------------------------------------
# tensor parallelism and FSDP (tests/test_torch_tp.py,
# tests/test_torch_train_tp*.py, tests/test_torch_ckpt_sharded.py)
# ---------------------------------------------------------------------------

def _tp_plan(grid, cfg, fsdp=False):
    from repro_torch.sharding import tp
    rules = make_rules(cfg, ShapeConfig("t", "train", 16, 4), grid,
                       fsdp=fsdp)
    return tp.make_plan(grid, rules), rules


def _leaf(x):
    return torch.from_numpy(np.asarray(x)).requires_grad_(True)


def _cut(full, plan, axes):
    from repro_torch.sharding import partition
    block = plan.block(axes)
    return partition.shard_leaf(full.detach(), block).requires_grad_(True)


def _grads(out, weight, leaves):
    return torch.autograd.grad((out * weight).sum(), leaves)


def tp_pieces(out_dir, seed: int = 0):
    """Each piece of ``sharding.tp`` on a 2-rank ``model`` world in fp32,
    forward and gradients, beside the one-process computation on the
    same inputs: the column -> row MLP, attention on local heads (qkv
    bias and qk-norm), the vocab-parallel embedding, and the cross
    entropy over a vocab of 250 padded to 256 (with and without a mask).
    Writes {piece: [(name, got, want), ...]}, the gradients of sharded
    leaves cut to this rank's block."""
    from repro_torch.models import layers as L
    from repro_torch.models.config import ModelConfig
    from repro_torch.sharding import tp
    grid = _grid((1, 2), ("data", "model"))
    cfg = ModelConfig(name="tp", family="dense", vocab=250, d_model=32,
                      n_layers=1, n_heads=4, n_kv_heads=2, d_ff=48,
                      head_dim=8, qkv_bias=True, qk_norm=True,
                      compute_dtype="float32")
    plan, _ = _tp_plan(grid, cfg)
    rng = np.random.default_rng(seed)
    B, S, d = 2, 8, cfg.d_model
    x_np = rng.standard_normal((B, S, d)).astype(np.float32)
    out = {}

    # column -> row MLP
    mcfg = L.MLPConfig(d_model=d, d_ff=cfg.d_ff)
    full = {k: _leaf(0.2 * rng.standard_normal(s).astype(np.float32))
            for k, s in (("w_up", (d, cfg.d_ff)), ("w_gate", (d, cfg.d_ff)),
                         ("w_down", (cfg.d_ff, d)))}
    axes = L.mlp_axes(mcfg)
    local = {k: _cut(v, plan, axes[k]) for k, v in full.items()}
    r = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    x1, x2 = _leaf(x_np), _leaf(x_np)
    want = L.mlp_fwd(full, x1, mcfg)
    got = tp.reduce_from_model(L.mlp_fwd(local, tp.copy_to_model(x2, plan),
                                         mcfg), plan)
    names = ["x"] + list(full)
    gw = _grads(want, r, [x1] + list(full.values()))
    gg = _grads(got, r, [x2] + list(local.values()))
    out["mlp"] = [("out", got.detach(), want.detach())] + [
        (n, a, b if n == "x" else _cut(b, plan, axes[n]).detach())
        for n, a, b in zip(names, gg, gw)]

    # attention on local heads
    acfg = L.AttentionConfig(d_model=d, n_heads=cfg.n_heads,
                             n_kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.head_dim, qkv_bias=True,
                             qk_norm=True)
    axes = L.attention_axes(acfg)
    shapes = {"wq": (d, 32), "wk": (d, 16), "wv": (d, 16), "wo": (32, d),
              "bq": (32,), "bk": (16,), "bv": (16,), "q_norm": (8,),
              "k_norm": (8,)}
    full = {k: _leaf((1.0 if k.endswith("norm") else 0.0) + 0.2
                     * rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}
    local = {k: _cut(v, plan, axes[k]) for k, v in full.items()}
    pos = torch.arange(S)[None, :]
    x1, x2 = _leaf(x_np), _leaf(x_np)
    want, _ = L.attention_fwd(full, x1, acfg, positions=pos)
    used = tp.gather_params(local, axes, plan, torch.float32)
    got, _ = L.attention_fwd(used, tp.copy_to_model(x2, plan),
                             plan.local_attention(acfg), positions=pos)
    got = tp.reduce_from_model(got, plan)
    names = ["x"] + list(full)
    gw = _grads(want, r, [x1] + list(full.values()))
    gg = _grads(got, r, [x2] + list(local.values()))
    out["attention"] = [("out", got.detach(), want.detach())] + [
        (n, a, b if n == "x" else _cut(b, plan, axes[n]).detach())
        for n, a, b in zip(names, gg, gw)]

    # vocab-parallel embedding and cross entropy (250 of 256 rows)
    V = cfg.padded_vocab
    table = _leaf(rng.standard_normal((V, d)).astype(np.float32))
    local_t = _cut(table, plan, L.embedding_axes()["table"])
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    e1 = L.embed({"table": table}, tokens)
    e2 = tp.vocab_embed(local_t, tokens, plan)
    g1 = _grads(e1, r, [table])[0]
    g2 = _grads(e2, r, [local_t])[0]
    out["embedding"] = [("out", e2.detach(), e1.detach()),
                        ("table", g2, _cut(g1, plan, ("vocab", "embed"))
                         .detach())]
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    mask = torch.from_numpy((rng.random((B, S)) < 0.7).astype(np.float32))
    for name, m in (("cross_entropy", None), ("cross_entropy_mask", mask)):
        h1, h2 = _leaf(x_np), _leaf(x_np)
        t1 = table.detach().clone().requires_grad_(True)
        t2 = _cut(table, plan, ("vocab", "embed"))
        want = L.cross_entropy_loss(L.unembed({"table": t1}, h1, cfg.vocab),
                                    labels, m)
        got = tp.vocab_parallel_cross_entropy(
            tp.copy_to_model(h2, plan) @ t2.t(), labels, m, cfg.vocab, plan)
        gw = torch.autograd.grad(want, [h1, t1])
        gg = torch.autograd.grad(got, [h2, t2])
        out[name] = [("loss", got.detach(), want.detach()),
                     ("hidden", gg[0], gw[0]),
                     ("table", gg[1], _cut(gw[1], plan, ("vocab", "embed"))
                      .detach())]
    out["stats"] = dict(grid.stats.calls)
    _save(out_dir, "tp_pieces", grid.rank, out)
    grid.close()


def ssm_block(out_dir, seed: int = 0):
    """The mamba2 block under a 2-rank ``model`` plan in fp32 (mamba2-780m
    smoke's widths: 8 SSD heads, 4 a rank), beside the one-process block
    on the same inputs: ``block_fwd`` over a prompt (its output, its
    gradients of the input and of every leaf, cut to this rank's block,
    its conv tail and final SSD state) and then ``block_decode`` of one
    token from those states.  Writes {piece: [(name, got, want), ...]}
    and the collectives' counts."""
    from repro_torch.models import mamba2 as M
    from repro_torch.sharding import partition, tp
    grid = _grid((1, 2), ("data", "model"))
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                              compute_dtype="float32")
    plan, rules = _tp_plan(grid, cfg)
    axes = M.block_axes(cfg)
    gen = torch.Generator().manual_seed(seed)
    full = M.init_block(gen, cfg, torch.float32, torch.device("cpu"))
    full["A_log"] = full["A_log"] + 0.1 * torch.randn(cfg.ssm_heads,
                                                      generator=gen)
    full["dt_bias"] = 0.3 * torch.randn(cfg.ssm_heads, generator=gen)
    full["norm"]["scale"] = 1 + 0.2 * torch.randn(cfg.d_inner, generator=gen)
    full["conv_bias"] = 0.1 * torch.randn(M.conv_channels(cfg),
                                          generator=gen)
    full = tree_map(lambda t: t.detach().requires_grad_(True), full)
    local = partition.map_axes(
        lambda ax, t: _cut(t, plan, ax), axes, full)
    B, S = 2, 12
    x_np = np.random.default_rng(seed).standard_normal(
        (B, S + 1, cfg.d_model)).astype(np.float32)
    r = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    x1, x2 = _leaf(x_np[:, :S]), _leaf(x_np[:, :S])
    want, (wc, ws) = M.block_fwd(full, x1, cfg)
    with partition.use_rules(rules, grid):
        got, (gc, gs) = M.block_fwd(local, x2, cfg)
    fa, fl, ll = (dict(_flat_named(t)) for t in (axes, full, local))
    names = ["x"] + list(fa)
    gw = _grads(want, r, [x1] + [fl[n] for n in fa])
    gg = _grads(got, r, [x2] + [ll[n] for n in fa])
    out = {"prefill": [("out", got.detach(), want.detach())] + [
        (n, a, b if n == "x" else _cut(b, plan, fa[n]).detach())
        for n, a, b in zip(names, gg, gw)]}
    # the rank's states: its heads' SSD state; its heads' x channels and
    # all of B and C of the conv tail
    di, m, k = cfg.d_inner, 2, grid.index(("model",))
    xs = slice(k * di // m, (k + 1) * di // m)
    rank_tail = torch.cat([wc[..., xs], wc[..., di:]], -1)
    rank_state = ws[:, k * 4:(k + 1) * 4]
    out["states"] = [("conv", gc.detach(), rank_tail.detach()),
                     ("ssd", gs.detach(), rank_state.detach())]
    one = _leaf(x_np[:, S:])
    with torch.no_grad():
        want, (wc, ws) = M.block_decode(full, one, cfg, conv_state=wc,
                                        ssd_state=ws)
        with partition.use_rules(rules, grid):
            grid.stats.reset()
            got, (gc, gs) = M.block_decode(local, one, cfg, conv_state=gc,
                                           ssd_state=gs)
            out["decode_stats"] = dict(grid.stats.calls)
    out["decode"] = [("out", got, want),
                     ("conv", gc, torch.cat([wc[..., xs], wc[..., di:]], -1)),
                     ("ssd", gs, ws[:, k * 4:(k + 1) * 4])]
    _save(out_dir, "ssm_block", grid.rank, out)
    grid.close()


def encdec_block(out_dir, seed: int = 0):
    """The encdec blocks under a 2-rank ``model`` plan in fp32
    (whisper-small smoke's widths: 4 heads, 2 a rank), beside the
    one-process blocks on the same inputs (norms and biases drawn away
    from their ones and zeros): ``enc_block_fwd``; ``dec_block_fwd``
    over ``cross_kv`` of encoder states behind ``copy_to_model``, with
    the gradients of the input, of the encoder states and of every leaf
    cut to this rank's block; the decoder block over a cache (a prompt,
    then one token) and the rank's kv heads of it; then the whole
    model: the loss and its gradients, the ``cross`` sums in one
    backward, and a decode step's collectives."""
    from repro_torch.models import encdec as E
    from repro_torch.sharding import partition, tp
    grid = _grid((1, 2), ("data", "model"))
    cfg = dataclasses.replace(get_config("whisper-small", smoke=True),
                              compute_dtype="float32")
    plan, rules = _tp_plan(grid, cfg)
    gen = torch.Generator().manual_seed(seed)
    cpu, f32 = torch.device("cpu"), torch.float32

    def drawn(tree):
        def one(name, t):
            if name.endswith("scale"):
                t = 1 + 0.2 * torch.randn(t.shape, generator=gen)
            elif name.endswith(("bias", "bq", "bk", "bv")):
                t = 0.1 * torch.randn(t.shape, generator=gen)
            return t.detach().requires_grad_(True)
        flat = dict(_flat_named(tree))
        it = iter(one(n, flat[n]) for n in flat)
        named = {n: next(it) for n in flat}
        return _unflatten(named)

    rng = np.random.default_rng(seed)
    B, S, Se, d = 2, 6, cfg.enc_seq, cfg.d_model
    k = grid.index(("model",))
    out = {}
    # the encoder block
    full = drawn(E.init_enc_block(gen, cfg, f32, cpu))
    axes = E.enc_block_axes(cfg)
    local = partition.map_axes(lambda ax, t: _cut(t, plan, ax), axes, full)
    x_np = rng.standard_normal((B, Se, d)).astype(np.float32)
    r = torch.from_numpy(rng.standard_normal((B, Se, d)).astype(np.float32))
    pos = torch.arange(Se)[None, :]
    x1, x2 = _leaf(x_np), _leaf(x_np)
    want = E.enc_block_fwd(full, x1, cfg, pos)
    with partition.use_rules(rules, grid):
        got = E.enc_block_fwd(local, x2, cfg, pos)
    fa, fl, ll = (dict(_flat_named(t)) for t in (axes, full, local))
    gw = _grads(want, r, [x1] + [fl[n] for n in fa])
    gg = _grads(got, r, [x2] + [ll[n] for n in fa])
    out["encoder"] = [("out", got.detach(), want.detach())] + [
        (n, a, b if n == "x" else _cut(b, plan, fa[n]).detach())
        for n, a, b in zip(["x"] + list(fa), gg, gw)]
    # the decoder block over cross K/V from the encoder states
    full = drawn(E.init_dec_block(gen, cfg, f32, cpu))
    axes = E.dec_block_axes(cfg)
    local = partition.map_axes(lambda ax, t: _cut(t, plan, ax), axes, full)
    x_np = rng.standard_normal((B, S + 1, d)).astype(np.float32)
    e_np = rng.standard_normal((B, Se, d)).astype(np.float32)
    r = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    pos = torch.arange(S)[None, :]
    x1, x2 = _leaf(x_np[:, :S]), _leaf(x_np[:, :S])
    e1, e2 = _leaf(e_np), _leaf(e_np)
    want = E.dec_block_fwd(full, x1, cfg, positions=pos,
                           enc_kv=E.cross_kv(full, cfg, e1))
    with partition.use_rules(rules, grid):
        shared = tp.copy_to_model(e2, plan, what="cross")
        got = E.dec_block_fwd(local, x2, cfg, positions=pos,
                              enc_kv=E.cross_kv(local, cfg, shared))
    fa, fl, ll = (dict(_flat_named(t)) for t in (axes, full, local))
    names = ["x", "enc_states"] + list(fa)
    gw = _grads(want, r, [x1, e1] + [fl[n] for n in fa])
    gg = _grads(got, r, [x2, e2] + [ll[n] for n in fa])
    out["decoder"] = [("out", got.detach(), want.detach())] + [
        (n, a, b if n in ("x", "enc_states") else
         _cut(b, plan, fa[n]).detach()) for n, a, b in zip(names, gg, gw)]
    # the same block over a cache: the prompt, then one token
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    heads = slice(k * KV // 2, (k + 1) * KV // 2)
    whole = [torch.zeros(B, S + 1, KV, hd) for _ in range(2)]
    mine = [torch.zeros(B, S + 1, KV // 2, hd) for _ in range(2)]
    out["cache"] = []
    with torch.no_grad():
        for at, n in ((0, S), (S, 1)):
            xs = torch.from_numpy(x_np[:, at:at + n])
            p = torch.arange(at, at + n)[None, :]
            want = E.dec_block_fwd(full, xs, cfg, positions=p,
                                   enc_kv=E.cross_kv(full, cfg, e1),
                                   kv_cache=whole, cache_index=at)
            with partition.use_rules(rules, grid):
                got = E.dec_block_fwd(local, xs, cfg, positions=p,
                                      enc_kv=E.cross_kv(local, cfg, e2),
                                      kv_cache=mine, cache_index=at)
            out["cache"].append((f"out{at}", got, want))
        out["cache"] += [(n, g, w[:, :, heads]) for n, g, w in
                         zip(("k", "v"), mine, whole)]
    # the whole model: the loss, its gradients and a step's collectives
    model = build_model(cfg, device="cpu")
    full = model.init(gen)
    full = tree_map(lambda t: t.detach().requires_grad_(True), full)
    axes = model.param_axes()
    local = partition.map_axes(lambda ax, t: _cut(t, plan, ax), axes, full)
    batch = {"frame_embeds": torch.from_numpy(
        rng.standard_normal((B, Se, d)).astype(np.float32)),
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
        "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    fa, fl, ll = (dict(_flat_named_all(t)) for t in (axes, full, local))
    want = model.loss(full, batch)
    gw = torch.autograd.grad(want, [fl[n] for n in fa])
    with partition.use_rules(rules, grid):
        grid.stats.reset()
        got = model.loss(local, batch)
        gg = torch.autograd.grad(got, [ll[n] for n in fa])
        out["loss_stats"] = dict(grid.stats.calls)
    out["model"] = [("loss", got.detach(), want.detach())] + [
        (n, a, _cut(b, plan, fa[n]).detach()) for n, a, b in zip(fa, gg, gw)]
    with torch.no_grad():
        served = tp.shard_params(model.load(full), axes, plan)
        cache = model.init_cache(B, S + 1, dtype=f32)
        with partition.use_rules(rules, grid):
            mine = model.init_cache(B, S + 1, dtype=f32)
            _, mine, enc = model.prefill(served, batch, mine)
            grid.stats.reset()
            got, mine = model.decode(served, batch["tokens"][:, :1], mine, S,
                                     enc)
            out["decode_stats"] = dict(grid.stats.calls)
        _, cache, enc = model.prefill(model.load(full), batch, cache)
        want, cache = model.decode(model.load(full), batch["tokens"][:, :1],
                                   cache, S, enc)
    V = got.shape[-1]
    out["decode"] = [("logits", got, want[..., k * V:(k + 1) * V]),
                     ("k", mine["k"], cache["k"][..., heads, :])]
    _save(out_dir, "encdec_block", grid.rank, out)
    grid.close()


def _unflatten(named):
    """The tree of dicts of ``_flat_named``'s (name, leaf) pairs."""
    tree = {}
    for name, t in named.items():
        *path, last = name.split("/")
        at = tree
        for p in path:
            at = at.setdefault(p, {})
        at[last] = t
    return tree


def _flat_named_all(tree, prefix=""):
    """``_flat_named`` through lists too (an item's index in its name)."""
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            yield from _flat_named_all(v, name)
        else:
            yield name, v


def _flat_named(tree, prefix=""):
    """(name, leaf) of a tree of dicts, keys sorted."""
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _flat_named(tree[k], name)
        else:
            yield name, tree[k]


TP_LAYOUTS = {"2x2": ((2, 2), ("data", "model")),
              "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
              "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
# (name, dp_mode, compress_pod, fsdp) per layout
TP_CASES = {"2x2": [("tp", "auto", False, False),
                    ("tp_fsdp", "auto", False, True)],
            "2x1x2": [("hierarchical", "hierarchical", False, False),
                      ("compress_pod", "hierarchical", True, False)],
            "2x2x1": [("auto", "auto", False, False),
                      ("hierarchical", "hierarchical", False, False)]}


def _combo_setup(d, arch, compute, vocab):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute, vocab=vocab)
    model = build_model(cfg, device="cpu")
    data = np.load(Path(d) / "inputs.npz")
    with open(Path(d) / "params.pkl", "rb") as f:
        params = bridge.params_from_reference(pickle.load(f), "cpu")
    return model, params, _batches(data)


def train_tp(out_dir, layout: str, combos, steps: int = 3, cases=None):
    """3 steps of each of the layout's ``TP_CASES`` (those named in
    ``cases``, default all) for each combo (a directory under
    ``out_dir`` with the reference's initial parameters and batches),
    each case's first step run twice in bits.  Rank 0 writes the
    gathered parameters; every rank its replicated leaves and
    (``compress_pod``) its step-1 residual."""
    from repro_torch.sharding import partition
    grid = _grid(*TP_LAYOUTS[layout])
    opt = AdamW(lr=LR)
    for sub, arch, compute, vocab in combos:
        d = Path(out_dir) / sub
        model, params, batches = _combo_setup(d, arch, compute, vocab)
        B, S = batches[0]["tokens"].shape
        shape = ShapeConfig("t", "train", S, B)
        axes = model.param_axes()
        out = {}
        for name, mode, compress, fsdp in TP_CASES[layout]:
            if cases is not None and name not in cases:
                continue
            tcfg = train.TrainStepConfig(dp_mode=mode, compress_pod=compress)
            rules = make_rules(model.cfg, shape, grid, fsdp=fsdp,
                               dp_mode=mode)
            step = train.make_train_step(model, opt, shape, mesh=grid,
                                         rules=rules, tcfg=tcfg)
            state = train.state_from_params(_clone(params), opt, tcfg,
                                            mesh=grid, rules=rules,
                                            axes=axes)
            first, m1 = step(state, batches[0])
            again, m2 = step(state, batches[0])
            twice = _same_bits(first, again) and all(
                torch.equal(m1[k], m2[k]) for k in m1)
            metrics = [{k: float(v) for k, v in m1.items()}]
            state = first
            for b in batches[1:steps]:
                state, m = step(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
            blocks = partition.tree_shardings(grid, rules, axes)
            full = tree_map(lambda t, b: partition.gather_leaf(t, b, grid),
                            state.params, blocks)
            replicated = {n: ts for n, ts, _ in _named_leaves(
                state.params, blocks) if ts is not None}
            out[name] = {"metrics": metrics, "twice": twice,
                         "replicated": replicated,
                         "params": (bridge.params_to_reference(full)
                                    if grid.rank == 0 else None),
                         "residual1": first.residuals.get("g") if compress
                         else None}
        if grid.rank == 0 and compute == "bfloat16" and \
                model.cfg.family in ("moe", "ssm", "hybrid", "encdec"):
            # the port's one-card step on the same batches (the bf16
            # rule of tests/_train_tp_common.py)
            step = train.make_train_step(model, opt, shape)
            state = train.state_from_params(_clone(params), opt)
            for b in batches[:steps]:
                state, _ = step(state, b)
            out["one_process"] = {
                "params": bridge.params_to_reference(state.params)}
        _save(d, f"train_tp_{layout}", grid.rank, out)
    grid.close()


def _named_leaves(tree, blocks):
    """(name, the leaves of a replicated leaf group or None, lead)."""
    from repro_torch.tree import leaf_groups
    for (name, ts, lead), (_, bs, _) in zip(leaf_groups(tree),
                                            leaf_groups(blocks)):
        yield name, (ts if all(b.whole for b in bs) else None), lead


CKPT_LAYOUTS = {**TP_LAYOUTS, "1x2": ((1, 2), ("data", "model")),
                "1": ((1, 1), ("data", "model"))}


def _ckpt_axes(model):
    pa = model.param_axes()
    return {"params": pa, "mu": pa, "nu": pa}


def _ckpt_rules(model, grid, fsdp):
    shape = ShapeConfig("t", "train", 32, 8)
    return make_rules(model.cfg, shape, grid, fsdp=fsdp), shape


def ckpt_write(out_dir, layout: str, fsdp: bool, name: str,
               arch: str = "qwen1.5-0.5b"):
    """One fp32 step on ``layout`` from the reference's parameters (the
    moments then non-zero), then a sharded checkpoint ``<out_dir>/<name>``
    of params, mu and nu; rank 0 writes the gathered state (numpy, the
    reference's stacked leaves) beside it."""
    from repro_torch.sharding import partition
    grid = _grid(*CKPT_LAYOUTS[layout])
    model, params, batches = _setup(out_dir, arch, "float32")
    opt = AdamW(lr=LR)
    rules, shape = _ckpt_rules(model, grid, fsdp)
    axes = _ckpt_axes(model)
    step = train.make_train_step(model, opt, shape, mesh=grid, rules=rules)
    state = train.state_from_params(params, opt, mesh=grid, rules=rules,
                                    axes=axes["params"])
    state, _ = step(state, batches[0])
    tree = _ckpt_tree(state)
    ckpt.save(Path(out_dir) / name, tree, step=1, extra={"by": layout},
              mesh=grid, rules=rules, axes=axes).wait()
    blocks = partition.tree_shardings(grid, rules, axes)
    full = tree_map(lambda t, b: partition.gather_leaf(t, b, grid), tree,
                    blocks)
    if grid.rank == 0:
        _save(out_dir, f"ckpt_full_{name}", 0,
              {k: bridge.params_to_reference(v) for k, v in full.items()})
    grid.close()


def ckpt_read(out_dir, layout: str, fsdp: bool, src: str,
              write: str = "", arch: str = "qwen1.5-0.5b"):
    """``elastic.replan`` of ``<out_dir>/<src>`` onto ``layout``'s grid
    (FSDP by ``fsdp``): this rank's restored blocks and the blocks'
    slices; with ``write``, the restored state saved again from this
    layout."""
    from repro_torch.sharding import partition
    grid = _grid(*CKPT_LAYOUTS[layout])
    model, params, _ = _setup(out_dir, arch, "float32")
    opt = AdamW(lr=LR)
    rules, _ = _ckpt_rules(model, grid, fsdp)
    axes = _ckpt_axes(model)
    template = _ckpt_tree(train.state_from_params(
        params, opt, mesh=grid, rules=rules, axes=axes["params"]))
    tree, extra = elastic.replan(Path(out_dir) / src, template, grid, rules,
                                 axes)
    if write:
        ckpt.save(Path(out_dir) / write, tree, step=extra["step"],
                  mesh=grid, rules=rules, axes=axes).wait()
    _save(out_dir, f"ckpt_read_{src}_{layout}", grid.rank, {
        "restored": tree, "step": extra["step"],
        "blocks": partition.tree_shardings(grid, rules, axes)})
    grid.close()


# ---------------------------------------------------------------------------
# serving under a model-axis lease (tests/test_torch_serve_tp.py)
# ---------------------------------------------------------------------------

def _join_world():
    """The running world over the ``file://`` store: the engine's grid is
    formed inside it (``LeaseBinding.join``)."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=os.environ["DIST_INIT"],
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=100))
    return dist


def serve_tp(out_dir, vocab: int, n_requests: int, prompt_len: int,
             max_new: int, slots: int, max_seq: int, page_size: int,
             tier1_pages: int, tier2_bytes: float, argmax_cases: str = ""):
    """The request-level engine from a ``(data 1, model m)`` lease on this
    world of m ranks, qwen1.5-0.5b smoke in fp32 with the reference's
    parameters (``<out_dir>/params.pkl``) over a burst trace; writes the
    tokens, clocks, stats, the Chrome trace and the page pool.  With
    ``argmax_cases`` (an ``.npz`` of full logits rows and vocab sizes)
    also ``tp.vocab_parallel_argmax`` of each case's columns of this
    rank."""
    from repro_torch.obs import Tracer, to_chrome_trace
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import (Engine, EngineConfig, KVBudget,
                                   burst_trace, latency_summary, run_trace)
    from repro_torch.sharding import tp
    dist = _join_world()
    m = dist.get_world_size()
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True),
                              compute_dtype="float32", vocab=vocab)
    model = build_model(cfg, device="cpu")
    with open(Path(out_dir) / "params.pkl", "rb") as f:
        params = bridge.params_from_reference(pickle.load(f), "cpu")
    lease = smoke_pool("scalepool").lease("serve-tp", m, tier2_gb=64,
                                          kv_gb=1.0, model_parallel=m)
    tracer = Tracer(1 << 16)
    engine = Engine.from_lease(
        model, lease, EngineConfig(max_slots=slots, max_seq=max_seq,
                                   page_size=page_size),
        params=params, budget=KVBudget(tier1_pages, tier2_bytes, page_size),
        tracer=tracer, device="cpu")
    trace = burst_trace(n_requests, prompt_len=prompt_len,
                        max_new_tokens=max_new, vocab=vocab, seed=0)
    handles = run_trace(engine, trace)
    out = {"tokens": [h.tokens for h in handles],
           "clocks": [(h.submit_clock, h.first_token_clock, h.done_clock)
                      for h in handles],
           "latency": latency_summary(handles), "stats": engine.stats(),
           "trace": to_chrome_trace(tracer),
           "pool": {k: v.clone() for k, v in engine._pool.items()},
           "grid": engine.grid.describe(),
           "collectives": dict(engine.grid.stats.calls),
           "page_bytes": engine.kv.page_bytes}
    if argmax_cases:
        plan = engine.plan
        data = np.load(argmax_cases)
        got = []
        for k in range(int(data["n"])):
            full = torch.from_numpy(data[f"logits{k}"])
            if bool(data[f"bf16{k}"]):
                full = full.to(torch.bfloat16)
            w = full.shape[-1] // m
            local = full[..., plan.model_index * w:(plan.model_index + 1) * w]
            got.append(tp.vocab_parallel_argmax(local, int(data[f"vocab{k}"]),
                                                plan))
        out["argmax"] = got
    _save(out_dir, "serve_tp", engine.grid.rank, out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the fixed-batch session on a lease's grid
# (tests/test_torch_serve_session_tp.py)
# ---------------------------------------------------------------------------

def serve_session(out_dir, accels: int, model_parallel: int, cases,
                  batch: int, prompt: int, generate: int, case_root: str):
    """``make_lease_session`` on a lease of ``accels`` and
    ``model_parallel`` in this world, for each case ``(directory, arch,
    compute, vocab)``: the reference's parameters
    (``<case_root>/<directory>/params.pkl``) loaded as the rank's shards,
    the prompts (and whisper's frames) of ``inputs.npz``, a prefill and
    ``generate - 1`` greedy decode steps over an fp32 cache.  Writes per
    case every step's global logits (``gather_logits``) and tokens, the
    rank's rows and cache shape, and the collectives the steps made."""
    from repro_torch.pool import smoke_pool
    from repro_torch.runtime.serve import make_lease_session
    dist = _join_world()
    out = {}
    for sub, arch, compute, vocab in cases:
        d = Path(case_root) / sub
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=compute, vocab=vocab)
        model = build_model(cfg, device="cpu")
        with open(d / "params.pkl", "rb") as f:
            raw = bridge.params_from_reference(pickle.load(f), "cpu")
        data = np.load(d / "inputs.npz")
        inputs = {"tokens": torch.from_numpy(data["tokens"]).long()}
        if "frames" in data:
            inputs["frame_embeds"] = torch.from_numpy(
                data["frames"]).to(torch.bfloat16)
        lease = smoke_pool("scalepool").lease(
            f"session-{sub}", accels, tier2_gb=8, kv_gb=1.0,
            model_parallel=model_parallel)
        sess = make_lease_session(
            model, ShapeConfig("s", "decode", prompt + generate, batch),
            lease, device="cpu")
        params = sess.load(raw)
        cache = sess.init_cache(batch, prompt + generate,
                                dtype=torch.float32)
        sess.grid.stats.reset()
        logits, cache, *enc = sess.prefill_step(params, inputs, cache)
        carry = {"tokens": sess.greedy(logits), "cache": cache,
                 "index": prompt}
        if enc:
            carry["enc_states"] = enc[0]
        blocks, tokens = [logits], [carry["tokens"]]
        for _ in range(generate - 1):
            logits, carry = sess.decode_step(params, carry)
            blocks.append(logits)
            tokens.append(carry["tokens"])
        calls = dict(sess.grid.stats.calls)
        out[sub] = {
            "logits": [sess.gather_logits(b) for b in blocks],
            "tokens": torch.cat(tokens, 1), "rows": sess.rows(batch),
            "cache": {k: tuple(v.shape) for k, v in carry["cache"].items()},
            "collectives": calls, "grid": sess.grid.describe(),
            "rules_batch": sess.plan.rules.spec("batch")[0]}
        sess.grid.close()
    _save(out_dir, "serve_session", dist.get_rank(), out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tenants of one lease under a model axis
# (tests/test_torch_serve_tenants_tp.py)
# ---------------------------------------------------------------------------

def serve_tenants(out_dir, vocab: int, slots: int, max_seq: int,
                  page_size: int, pool_pages: int, kv_gb: float, traces):
    """Two tenants of one ``(data 1, model m)`` lease over one
    ``PoolArbiter`` on this world of m ranks (qwen1.5-0.5b smoke in fp32,
    the reference's parameters from ``<out_dir>/params.pkl``), each
    tenant's requests from ``traces`` ({tenant: [(prompt, max_new,
    arrival)]}), through ``run_multi_trace`` with the pages checked
    after every step; writes the tokens, clocks, stats, the arbiter's
    stats, the Chrome trace and the pool."""
    from repro_torch.obs import Tracer, to_chrome_trace
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import (Engine, EngineConfig, PoolArbiter,
                                   Request, run_multi_trace)
    dist = _join_world()
    m = dist.get_world_size()
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True),
                              compute_dtype="float32", vocab=vocab)
    model = build_model(cfg, device="cpu")
    with open(Path(out_dir) / "params.pkl", "rb") as f:
        params = bridge.params_from_reference(pickle.load(f), "cpu")
    names = sorted(traces)
    lease = smoke_pool("scalepool").lease(
        "tenants-tp", m, tier2_gb=64, kv_gb=kv_gb, model_parallel=m,
        tenants=tuple(names))
    tracer = Tracer(1 << 16)
    arb = PoolArbiter(pool_pages, page_size=page_size, tracer=tracer)
    ecfg = EngineConfig(max_slots=slots, max_seq=max_seq,
                        page_size=page_size)
    engines = [Engine.from_lease(model, lease, ecfg, params=params,
                                 arbiter=arb, tenant=n, tracer=tracer,
                                 device="cpu") for n in names]
    checked = [0]
    for eng in engines:
        def step(orig=eng.step):
            dt = orig()
            arb.check_conservation()
            checked[0] += 1
            return dt
        eng.step = step
    lists = run_multi_trace([
        (e, [Request(tuple(p), n, arrival_time=t) for p, n, t in traces[name]])
        for e, name in zip(engines, names)])
    grid = arb.grid
    out = {"tokens": [[h.tokens for h in hs] for hs in lists],
           "clocks": [[(h.submit_clock, h.first_token_clock, h.done_clock)
                       for h in hs] for hs in lists],
           "stats": [e.stats() for e in engines], "arbiter": arb.stats(),
           "trace": to_chrome_trace(tracer), "checked": checked[0],
           "pool": {k: v.clone() for k, v in arb.pool.items()},
           "grids": [e.grid is grid for e in engines],
           "grid": grid.describe(), "page_bytes": arb.page_bytes,
           "collectives": dict(grid.stats.calls)}
    _save(out_dir, "serve_tenants", grid.rank, out)
    grid.close()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# disaggregated tiers and co-resident engines under a model axis
# (tests/test_torch_disagg_tp.py, tests/test_torch_colo_tp.py)
# ---------------------------------------------------------------------------

def _smoke_fp32(out_dir, vocab: int, arch: str = "qwen1.5-0.5b"):
    """``arch``'s smoke config (qwen1.5-0.5b's by default) in fp32 and the
    reference's parameters (``<out_dir>/params.pkl``) as the port's full
    tree."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32", vocab=vocab)
    model = build_model(cfg, device="cpu")
    with open(Path(out_dir) / "params.pkl", "rb") as f:
        params = bridge.params_from_reference(pickle.load(f), "cpu")
    return model, params


def _port_namespace():
    import types
    from repro_torch import disagg, serve
    from repro_torch.core import fabric as fb
    from repro_torch.fabric import Topology, Transport
    from repro_torch.obs import Tracer
    return types.SimpleNamespace(serve=serve, disagg=disagg, fb=fb,
                                 Topology=Topology, Transport=Transport,
                                 Tracer=Tracer)


def serve_disagg(out_dir, vocab: int, cases,
                 model_parallel: Optional[int] = None,
                 slots: Optional[int] = None, arch: str = "qwen1.5-0.5b"):
    """Each of ``cases`` (``tests/_disagg_scenarios.py``) on this world
    of n ranks: every engine of both tiers from the members of one
    ``lease_gang`` of n accelerators each with ``model_parallel``
    (default n), on one grid, with ``slots`` decode rows an engine
    (default the scenarios'); writes each case's outcome, Chrome trace
    and decode pools, whether every engine served on the one grid, both
    members' layouts, and the message a cluster whose decode engine sits
    on a second grid raises.  ``arch``: the smoke config served
    (qwen1.5-0.5b's by default)."""
    import _disagg_scenarios as D
    from repro_torch.disagg import DisaggCluster, PrefillWorker
    from repro_torch.obs import to_chrome_trace
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import Engine
    dist = _join_world()
    m = dist.get_world_size()
    model, params = _smoke_fp32(out_dir, vocab, arch)
    S = _port_namespace()
    gang = smoke_pool("scalepool").lease_gang(
        "disagg-tp", {"prefill": dict(n_accels=m),
                      "decode": dict(n_accels=m, tier2_gb=8, kv_gb=1.0)},
        model_parallel=model_parallel or m)
    bindings = {role: gang[role].materialize(["cpu"]) for role in gang}
    grid = bindings["prefill"].join()
    ecfg = D.engine_config(S)
    if slots is not None:
        ecfg = dataclasses.replace(ecfg, max_slots=slots)

    def engine(role, tenant, tracer, on=grid):
        return Engine.from_lease(model, gang[role], ecfg,
                                 params=params, budget=D.budget(S, role),
                                 tenant=tenant, tracer=tracer, grid=on,
                                 device="cpu")

    out = {"layouts": {r: b.layout.as_dict() for r, b in bindings.items()},
           "grid": grid.describe(), "cases": {}}
    for case in cases:
        cluster, tx, handles, tracer = D.run(S, case, engine, vocab)
        engines = ([w.engine for w in cluster.prefill_workers]
                   + cluster.decode_engines)
        out["cases"][case] = {
            **D.outcome(cluster, tx, handles),
            "trace": to_chrome_trace(tracer), "dropped": tracer.dropped,
            "pools": [{k: v.clone() for k, v in e._pool.items()}
                      for e in cluster.decode_engines],
            "one_grid": all(e.grid is grid for e in engines),
            "kv_heads": [e.kv_heads for e in engines],
            "trash": [e._trash for e in cluster.decode_engines]}
    other = bindings["decode"].join()
    try:
        DisaggCluster([PrefillWorker(engine("prefill", None, None))],
                      [engine("decode", "d0", None, on=other)])
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    out["collectives"] = dict(grid.stats.calls)
    _save(out_dir, "serve_disagg", grid.rank, out)
    other.close()
    grid.close()
    dist.destroy_process_group()


def serve_colo(out_dir, vocab: int, n_requests: int, n_steps: int,
               model_parallel: Optional[int] = None,
               arch: str = "qwen1.5-0.5b"):
    """fig11's hop-only run (``chip_smoke.co_run``) on this world of n
    ranks: both tenants' engines from one lease of n accelerators with
    ``model_parallel`` (default n) on one grid, sharing one
    ``Transport`` with the training job's ``TrainActor``; writes the
    outcome, the clocks, every engine's clock and stats, the Chrome
    trace, whether both served on one grid and each engine's pool.
    ``arch``: the smoke config served (qwen1.5-0.5b's by default)."""
    import sys
    from repro_torch.obs import Tracer, to_chrome_trace
    from repro_torch.pool import smoke_pool
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    dist = _join_world()
    m = dist.get_world_size()
    model, params = _smoke_fp32(out_dir, vocab, arch)
    lease = smoke_pool("scalepool").lease(
        "colo-tp", m, tier2_gb=8, kv_gb=1.0,
        model_parallel=model_parallel or m)
    bw, page_bytes = cs.co_bw(model, params, torch.device("cpu"))
    tracer = Tracer(1 << 18)
    r = cs.co_run(model, params, torch.device("cpu"), "scalepool", n_steps,
                  cs.co_traces(n_requests), bw, tracer=tracer, lease=lease)
    grid = r["grid"]
    out = {"outcome": cs.co_outcome(r),
           "clocks": {t: [(h.submit_clock, h.first_token_clock, h.done_clock)
                          for h in hs] for t, hs in r["handles"].items()},
           "engine_clocks": {t: e.clock for t, e in r["engines"].items()},
           "stats": {t: e.stats() for t, e in r["engines"].items()},
           "trace": to_chrome_trace(tracer), "dropped": tracer.dropped,
           "one_grid": all(e.grid is grid for e in r["engines"].values()),
           "mesh": grid.layout.as_dict(), "bw": bw, "page_bytes": page_bytes,
           "kv_heads": [e.kv_heads for e in r["engines"].values()],
           "pools": {t: {k: v[:, :e._trash].clone()
                         for k, v in e._pool.items()}
                     for t, e in r["engines"].items()},
           "collectives": dict(grid.stats.calls)}
    _save(out_dir, "serve_colo", grid.rank, out)
    grid.close()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the engine on a lease with a data or pod axis over 1
# (tests/test_torch_serve_dp.py, tests/test_torch_disagg_colo_dp.py)
# ---------------------------------------------------------------------------

def _record_rows(engine, calls, drops=None):
    """Each ``decode_paged`` call of ``engine`` appends its rows: (count,
    lengths, first page of each row's table); with ``drops`` (a list of
    one int) the moe layers' dropped entries of the call's real rows are
    added to ``drops[0]``."""
    from repro_torch.models import moe
    inner = engine.model.decode_paged

    def decode_paged(p, toks, pools, table, lengths):
        calls.append((int(toks.shape[0]), lengths.tolist(),
                      table[:, 0].tolist()))
        if drops is None:
            return inner(p, toks, pools, table, lengths)
        with moe.record_routing() as routing:
            out = inner(p, toks, pools, table, lengths)
        drops[0] += sum(int((~r["kept"]).sum()) for r in routing)
        return out
    engine.model = dataclasses.replace(engine.model,
                                       decode_paged=decode_paged)


def _record_slots(engine, placed):
    """Each placement of a row by ``engine`` appends its slot to
    ``placed[rid]``."""
    place = engine._place

    def record(st, slot):
        placed.setdefault(st.rid, []).append(slot)
        place(st, slot)
    engine._place = record


def _requests(rows):
    from repro_torch.serve import Request
    return [Request(tuple(p), n, arrival_time=t) for p, n, t in rows]


def serve_dp(out_dir, vocab: int, accels: int, model_parallel: int,
             cases, requests, tenant_traces, max_seq: int, page_size: int,
             tier2_bytes: float, kv_gb: float, arch: str = "qwen1.5-0.5b"):
    """The request-level engine from a lease of ``accels`` with
    ``model_parallel`` on this world (its (pod, data, model) grid),
    ``arch``'s smoke config (qwen1.5-0.5b's by default) in fp32 with the
    reference's parameters (``<out_dir>/params.pkl``), for each of
    ``cases`` (``(name, slots, pages)``) over ``requests`` (``[(prompt,
    max_new, arrival)]``, or ``{case: requests}``), every engine on the
    grid the first joined;
    with ``tenant_traces`` ({tenant: requests}, ``(slots, pages)`` the
    case ``"tenants"``) two tenants of one lease over one arbiter.
    Writes each case's tokens, clocks, stats, Chrome trace, pool, every
    decode call's rows, every row's slots, the collectives and (moe) the
    entries its decode calls dropped."""
    from repro_torch.obs import Tracer, to_chrome_trace
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import (Engine, EngineConfig, KVBudget,
                                   PoolArbiter, latency_summary,
                                   run_multi_trace, run_trace)
    dist = _join_world()
    model, params = _smoke_fp32(out_dir, vocab, arch)
    pool = smoke_pool("scalepool")
    lease = pool.lease("serve-dp", accels, tier2_gb=64, kv_gb=kv_gb,
                       model_parallel=model_parallel)
    moe = model.cfg.family == "moe"
    grid, out = None, {}
    for name, slots, pages in cases:
        ecfg = EngineConfig(max_slots=slots, max_seq=max_seq,
                            page_size=page_size)
        tracer = Tracer(1 << 16)
        if name == "tenants":
            tl = pool.lease("serve-dp-tenants", accels, tier2_gb=64,
                            kv_gb=kv_gb, model_parallel=model_parallel,
                            tenants=tuple(sorted(tenant_traces)))
            arb = PoolArbiter(pages, page_size=page_size, tracer=tracer)
            engines = [Engine.from_lease(model, tl, ecfg, params=params,
                                         arbiter=arb, tenant=t,
                                         tracer=tracer, grid=grid,
                                         device="cpu")
                       for t in sorted(tenant_traces)]
        else:
            arb = None
            engines = [Engine.from_lease(
                model, lease, ecfg, params=params, tracer=tracer, grid=grid,
                budget=KVBudget(pages, tier2_bytes, page_size),
                device="cpu")]
        grid = engines[0].grid
        calls, placed = [[] for _ in engines], [{} for _ in engines]
        drops = [0] if moe else None
        for e, c, p in zip(engines, calls, placed):
            _record_rows(e, c, drops)
            _record_slots(e, p)
        grid.stats.reset()
        if arb is None:
            rows = requests[name] if isinstance(requests, dict) else requests
            lists = [run_trace(engines[0], _requests(rows))]
        else:
            lists = run_multi_trace([
                (e, _requests(tenant_traces[t]))
                for e, t in zip(engines, sorted(tenant_traces))])
        out[name] = {
            "tokens": [[h.tokens for h in hs] for hs in lists],
            "clocks": [[(h.submit_clock, h.first_token_clock, h.done_clock)
                        for h in hs] for hs in lists],
            "latency": [latency_summary(hs) for hs in lists],
            "stats": [e.stats() for e in engines],
            "arbiter": None if arb is None else arb.stats(),
            "trace": to_chrome_trace(tracer), "dropped": tracer.dropped,
            "pool": {k: v.clone() for k, v in engines[0]._pool.items()},
            "trash": engines[0]._trash, "calls": calls, "placed": placed,
            "rules_batch": engines[0].plan.rules.spec("batch")[0],
            "batch_axes": engines[0].plan.batch_axes,
            "collectives": dict(grid.stats.calls),
            "one_grid": all(e.grid is grid for e in engines),
            "kv_heads": engines[0].kv_heads,
            "decode_drops": None if drops is None else drops[0]}
    out["grid"] = grid.describe()
    _save(out_dir, "serve_dp", grid.rank, out)
    grid.close()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# moe expert parallelism (tests/test_torch_moe_ep.py,
# tests/test_torch_train_moe_tp.py, tests/test_torch_serve_moe_dp.py)
# ---------------------------------------------------------------------------

# name -> (grid shape, axes, n_experts): the experts over model (8 of
# them on 4 ranks), their expert_ff columns (6 do not divide 4), rows
# over data, rows over pod
MOE_LAYOUTS = {"1x4": ((1, 4), ("data", "model"), 8),
               "1x4_ff": ((1, 4), ("data", "model"), 6),
               "2x2": ((2, 2), ("data", "model"), 8),
               "2x1x2": ((2, 1, 2), ("pod", "data", "model"), 8)}
MOE_AUX_WEIGHT = 0.5


def moe_layer(out_dir, cases):
    """``moe.moe_mlp_fwd`` on each of ``MOE_LAYOUTS``' grids (formed in
    this world of 4 ranks) for each case ``(capacity factor, compute)``:
    the rank's rows of ``<out_dir>/moe_layer.npz``'s batch (the rules'
    ``batch`` axes, the dispatch group the whole batch), the rank's
    blocks of the layer's weights.  Writes the rank's rows of the output,
    the aux loss, the routing ``record_routing`` saw and, in fp32, the
    gradients of ``n * sum(out * r) + MOE_AUX_WEIGHT * aux`` (n the
    group's size) averaged over the batch axes, as the training step's
    data-parallel mean: the router's and the rank's blocks of ``w_*``,
    and x's for the rank's rows (over n)."""
    from repro_torch.models import moe
    from repro_torch.sharding import partition, tp
    dist = _join_world()
    data = np.load(Path(out_dir) / "moe_layer.npz")
    x_all, r_all = data["x"], data["r"]
    B, S, _ = x_all.shape
    out = {}
    for name, (shape, axes, E) in MOE_LAYOUTS.items():
        grid = mesh_lib.init_grid(mesh_lib.Layout(shape, axes),
                                  rank=dist.get_rank(),
                                  device=torch.device("cpu"))
        for cf, compute in cases:
            dtype = getattr(torch, compute)
            cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                                      n_experts=E, capacity_factor=cf,
                                      compute_dtype=compute)
            rules = make_rules(cfg, ShapeConfig("t", "train", S, B), grid,
                               fsdp=False)
            plan = tp.make_plan(grid, rules)
            split = tp.split_of(grid, plan.batch_axes)
            start, rows = plan.rows(B)
            full = {k: torch.from_numpy(data[f"E{E}_{k}"]).to(dtype)
                    for k in ("router", "w_gate", "w_up", "w_down")}
            full["router"] = full["router"].float()
            axes_ = moe.moe_mlp_axes()
            local = {k: partition.shard_leaf(v, plan.block(axes_[k]))
                     .requires_grad_(compute == "float32")
                     for k, v in full.items()}
            x = torch.from_numpy(x_all[start:start + rows]).to(dtype)
            x.requires_grad_(compute == "float32")
            with partition.use_rules(rules, grid), tp.split_rows(split), \
                    moe.record_routing() as calls:
                y, aux = moe.moe_mlp_fwd(local, x, cfg)
                res = {"out": y.detach().float(), "aux": float(aux),
                       "rows": (start, rows),
                       "expert_idx": calls[0]["expert_idx"][0],
                       "kept": calls[0]["kept"][0],
                       "keep": calls[0]["keep"][0],
                       "blocks": {k: plan.block(axes_[k]).slices(v.shape)
                                  for k, v in full.items()}}
                if compute == "float32":
                    n = 1 if split is None else split.n
                    r = torch.from_numpy(r_all[start:start + rows])
                    leaves = [x] + [local[k] for k in sorted(local)]
                    loss = n * (y * r).sum() + MOE_AUX_WEIGHT * aux
                    grads = torch.autograd.grad(loss, leaves)
                    res["grad_x"] = grads[0] / n
                    for k, g in zip(sorted(local), grads[1:]):
                        if split is not None:
                            g = h.all_reduce(g.clone(), grid,
                                             split.axes) / split.n
                        res[f"grad_{k}"] = g
            res["collectives"] = dict(grid.stats.calls)
            grid.stats.reset()
            out[(name, cf, compute)] = res
        grid.close()
    _save(out_dir, "moe_layer", dist.get_rank(), out)
    dist.destroy_process_group()
