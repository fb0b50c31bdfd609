"""Shared by ``tests/test_torch_train_tp.py`` (the ``(data 2, model 2)``
layout, FSDP off and on) and ``tests/test_torch_train_tp_pod.py`` (the
``(pod 2, data 1, model 2)`` layout, ``hierarchical`` with and without
``compress_pod``): the port's 4-rank worlds (``_dist_ranks.train_tp``)
against the reference's real sharded ``make_train_step`` on a mesh of
four forced host devices with ``AxisType.Auto`` axes, in a subprocess,
both from the reference's ``model.init(PRNGKey(0))`` and the same numpy
batches (B=8 x S=32, 3 steps).

Combos: qwen1.5-0.5b and olmo-1b smoke, and qwen with a vocab of 250
(its table padded to 256 rows: the rank holding the padded rows leaves
them out of the loss), each in fp32 and bf16 compute.  Tolerances, the
parameters' rule and the ``compress_pod`` residual comparison (C-ref8)
are ``tests/test_torch_train_dist.py``'s.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

import jax

from repro.configs import SMOKE_ARCHS
from repro.models.api import build_model as ref_build

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import load, run_world                       # noqa: E402
from test_torch_train_dist import (TOL, _close_params,        # noqa: E402
                                   _port_params, _ref_params)

ROOT = Path(__file__).resolve().parent.parent
# (directory, arch, compute, vocab)
COMBOS = [("qwen_f32", "qwen1.5-0.5b", "float32", 256),
          ("qwen_bf16", "qwen1.5-0.5b", "bfloat16", 256),
          ("olmo_f32", "olmo-1b", "float32", 256),
          ("olmo_bf16", "olmo-1b", "bfloat16", 256),
          ("qwen250_f32", "qwen1.5-0.5b", "float32", 250),
          ("qwen250_bf16", "qwen1.5-0.5b", "bfloat16", 250)]
B, S, STEPS = 8, 32, 3
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# name -> (dp_mode, compress_pod, fsdp), as _dist_ranks.TP_CASES
CASES = {"2x2": {"tp": ("auto", False, False),
                 "tp_fsdp": ("auto", False, True)},
         "2x1x2": {"hierarchical": ("hierarchical", False, False),
                   "compress_pod": ("hierarchical", True, False)}}

REFERENCE = """
import json, pickle, sys, dataclasses
from pathlib import Path
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import SMOKE_ARCHS
from repro.core.compat import mesh_context
from repro.models.api import build_model
from repro.models.config import ShapeConfig
from repro.optim.adamw import AdamW
from repro.runtime import train as tr
from repro.sharding.partition import use_rules
from repro.sharding.profiles import make_rules

root = Path(sys.argv[1])
shape_, axes = json.loads(sys.argv[2])
mesh = jax.make_mesh(tuple(shape_), tuple(axes),
                     axis_types=(AxisType.Auto,) * len(axes))
cases = json.loads(sys.argv[3])

def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}

for sub, arch, compute, vocab in json.loads(sys.argv[4]):
    d = root / sub
    data = np.load(d / "inputs.npz")
    with open(d / "params.pkl", "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype=compute,
                              vocab=vocab)
    model = build_model(cfg)
    opt = AdamW(lr=1e-3)
    B, S = data["tokens"].shape[1:]
    shape = ShapeConfig("t", "train", int(S), int(B))
    out = {}
    for name, (mode, compress, fsdp) in cases.items():
        tcfg = tr.TrainStepConfig(dp_mode=mode, compress_pod=compress)
        rules = make_rules(cfg, shape, mesh, fsdp=fsdp, dp_mode=mode)
        step, shardings = tr.make_train_step(model, opt, shape, mesh=mesh,
                                             rules=rules, tcfg=tcfg)
        res = {"g": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                 params)} if compress else {}
        state = jax.device_put(tr.TrainState(params, opt.init(params), res),
                               shardings)
        jstep = jax.jit(step)
        metrics = []
        with use_rules(rules, mesh), mesh_context(mesh):
            for k in range(data["tokens"].shape[0]):
                state, m = jstep(state, {"tokens": jnp.asarray(data["tokens"][k]),
                                         "labels": jnp.asarray(data["labels"][k])})
                metrics.append({n: float(v) for n, v in m.items()})
                if compress and k == 0:
                    for path, a in flat(state.residuals["g"]).items():
                        out[f"{name}/residual1{path}"] = a
        for path, a in flat(state.params).items():
            out[f"{name}/params{path}"] = a
        out[f"{name}/metrics"] = np.array(
            [[m["loss"], m["grad_norm"], m["step"]] for m in metrics])
    np.savez(d / "reference.npz", **out)
print("OK")
"""


def _inputs(d: Path, arch: str, vocab: int) -> None:
    """The reference's initial parameters (its config with ``vocab``) and
    the batches, as numpy."""
    import dataclasses
    cfg = dataclasses.replace(SMOKE_ARCHS[arch], vocab=vocab)
    params = ref_build(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    np.savez(d / "inputs.npz",
             tokens=rng.integers(0, vocab, (STEPS, B, S)).astype(np.int32),
             labels=rng.integers(0, vocab, (STEPS, B, S)).astype(np.int32))


def run_layout(root: Path, layout: str):
    """{combo directory: (reference npz, [each rank's findings])}: the
    reference in one subprocess, the port's world meanwhile."""
    for sub, arch, _, vocab in COMBOS:
        _inputs(root / sub, arch, vocab)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(root),
         json.dumps(MESHES[layout]), json.dumps(CASES[layout]),
         json.dumps(COMBOS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        run_world(4, "train_tp", root, timeout=240, layout=layout,
                  combos=COMBOS, steps=STEPS)
        out, _ = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "OK" in out, out[-4000:]
    return {c[0]: (np.load(root / c[0] / "reference.npz"),
                   [load(root / c[0], f"train_tp_{layout}", r)
                    for r in range(4)]) for c in COMBOS}


def check_against_reference(runs, sub, case):
    """3 steps of ``case``: every rank's loss and grad norm per step, and
    the gathered final parameters, against the reference's."""
    ref, ranks = runs[sub]
    compute = next(c[2] for c in COMBOS if c[0] == sub)
    loss_tol, norm_tol, param_tol = TOL[compute]
    want = ref[f"{case}/metrics"]
    for rank in ranks:
        got = rank[case]["metrics"]
        for k in range(STEPS):
            assert abs(got[k]["loss"] - want[k, 0]) <= loss_tol * abs(
                want[k, 0]), (k, got[k]["loss"], want[k, 0])
            assert abs(got[k]["grad_norm"] - want[k, 1]) <= norm_tol * abs(
                want[k, 1]), (k, got[k]["grad_norm"], want[k, 1])
            assert got[k]["step"] == want[k, 2] == k + 1
    _close_params(_port_params(ranks[0][case]["params"]),
                  _ref_params(ref, case), param_tol)


def check_bits(runs, sub, case):
    """Every rank's first step twice in the same bits, and every
    replicated leaf in the same bits on every rank (the ranks of a
    ``model`` group, and across the data ranks; olmo's norms have no
    parameters, so all its leaves are sharded)."""
    _, ranks = runs[sub]
    first = ranks[0][case]["replicated"]
    assert bool(first) == sub.startswith("qwen")
    for rank in ranks:
        assert rank[case]["twice"]
        got = rank[case]["replicated"]
        assert got.keys() == first.keys()
        for name in first:
            assert all(a.equal(b) for a, b in zip(got[name], first[name])), \
                name


def check_residuals(runs, sub, case):
    """Step 1's ``compress_pod`` residuals from equal parameters (the
    rule of ``test_torch_train_dist.
    test_compress_pod_residuals_match_the_reference_pod``).  The
    reference returns pod 0's whole leaves (C-ref8); on ``(pod 2, data
    1, model 2)`` ranks 0 and 1 are pod 0's model blocks, each holding
    its blocks of every leaf laid end to end in the reference's leaf
    order: each reference leaf is cut to each rank's block to compare."""
    import torch
    from repro_torch.launch.mesh import Layout
    from repro_torch.models.transformer import block_axes
    from repro_torch.configs import get_config
    from repro_torch.models.layers import embedding_axes, norm_axes
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import partition
    from repro_torch.sharding.profiles import make_rules
    import dataclasses
    ref, ranks = runs[sub]
    arch, vocab = next((c[1], c[3]) for c in COMBOS if c[0] == sub)
    cfg = dataclasses.replace(get_config(arch, smoke=True), vocab=vocab)
    layout = Layout(*MESHES["2x1x2"])
    mode, _, fsdp = CASES["2x1x2"][case]
    rules = make_rules(cfg, ShapeConfig("t", "train", S, B), layout,
                       fsdp=fsdp, dp_mode=mode)
    axes = dict(partition.named_axes({
        "embedding": embedding_axes(), "layers": [block_axes(cfg)],
        "final_norm": norm_axes(cfg.norm_type)}))
    pre = f"{case}/residual1"
    keys = [k for k in ref.files if k.startswith(pre)]
    at = flips = 0
    for r in (0, 1):
        got = ranks[r][case]["residual1"].numpy()
        at = 0
        coords = layout.coords(r)
        for key in keys:
            name = "/".join(p.strip("[]'") for p in
                            key[len(pre):].split("]["))
            whole = ref[key]
            lead = whole.ndim - len(axes[name])
            block = partition.block_of(layout, coords, rules, axes[name])
            want = whole[(slice(None),) * lead
                         + block.slices(whole.shape[lead:])].reshape(-1)
            part = got[at:at + want.size]
            at += want.size
            step = 2 * np.abs(whole).max()
            diff = np.abs(part - want)
            flip = diff > 1e-5 * 127 * step
            assert np.all(np.abs(diff[flip] - step) <= 0.01 * step), key
            flips += int(flip.sum())
        assert not got[at:].any()               # the padding stays 0
    assert flips <= 1e-4 * 2 * at, (flips, at)
    del torch
