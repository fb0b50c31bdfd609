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
    each pod's vector with its residual, 20 error-feedback steps, and the
    byte counter under the three gradient schedules."""
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
    _save(out_dir, "hierarchy", r, out)
    grid.close()


def _setup(out_dir, arch, compute):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    model = build_model(cfg, device="cpu")
    data = np.load(Path(out_dir) / "inputs.npz")
    with open(Path(out_dir) / "params.pkl", "rb") as f:
        params = bridge.params_from_reference(pickle.load(f), "cpu")
    batches = [{"tokens": data["tokens"][k], "labels": data["labels"][k]}
               for k in range(data["tokens"].shape[0])]
    return model, params, batches


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


TP_LAYOUTS = {"2x2": ((2, 2), ("data", "model")),
              "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# (name, dp_mode, compress_pod, fsdp) per layout
TP_CASES = {"2x2": [("tp", "auto", False, False),
                    ("tp_fsdp", "auto", False, True)],
            "2x1x2": [("hierarchical", "hierarchical", False, False),
                      ("compress_pod", "hierarchical", True, False)]}


def _combo_setup(d, arch, compute, vocab):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute, vocab=vocab)
    model = build_model(cfg, device="cpu")
    data = np.load(Path(d) / "inputs.npz")
    with open(Path(d) / "params.pkl", "rb") as f:
        params = bridge.params_from_reference(pickle.load(f), "cpu")
    batches = [{"tokens": data["tokens"][k], "labels": data["labels"][k]}
               for k in range(data["tokens"].shape[0])]
    return model, params, batches


def train_tp(out_dir, layout: str, combos, steps: int = 3):
    """3 steps of each of the layout's ``TP_CASES`` for each combo (a
    directory under ``out_dir`` with the reference's initial parameters
    and batches), each case's first step run twice in bits.  Rank 0
    writes the gathered parameters; every rank its replicated leaves and
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
