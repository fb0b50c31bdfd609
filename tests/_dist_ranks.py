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
