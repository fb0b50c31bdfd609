"""The ssm and hybrid families' fixed-batch session under a ``model``
axis: ``runtime.serve.make_lease_session`` in worlds of 4 ranks over
gloo (``tests/_dist_world.py``), each rank serving its block of the rows
on its shards of the model (the mamba2 block's SSD heads and conv
channels, zamba2's shared attention heads), against the reference's
real ``make_prefill_step`` / ``make_decode_step`` jitted under
``use_rules(make_rules(..., fsdp=False), mesh)`` on an ``AxisType.Auto``
mesh of forced host devices, in a subprocess
(``tests/test_torch_serve_session_tp.py``'s).  Both start from the
reference's ``model.init(PRNGKey(0))`` (through numpy) and the same
numpy prompts: B=4 x 8 tokens, 4 generated (a prefill, 3 decode steps)
over an fp32 cache; mamba2-780m and zamba2-7b smoke in fp32 and bf16 on

* (data 2, model 2): rows over ``data``, 4 of the 8 SSD heads a rank,
  zamba2's 2 of 4 attention heads;
* (data 1, model 4): every row, 2 SSD heads a rank, one attention head.

Every step's logits, gathered from the ranks, lie within ``TOL`` of the
largest |logit| of the reference's, in bf16 within twice the
reference's own distance between its sharded and one-device steps where
that is the larger (ROADMAP C-port12: zamba2's bf16 logits part by
~3% of the largest between the reference's two programs); the greedy
tokens are identical but where the reference's top-2 margin lies within
that bound (a tie, C-ref3: the row then leaves the comparison); the
greedy tokens are identical (a
divergence reports the reference's top-2 margin there, C-ref3) and the
same on every rank; each rank's cache holds its rows, SSD heads, conv
channels (its heads' x and all of B and C) and kv heads; the
collectives are each step's greedy gathers and, a mamba2 layer, the
gather of ``in_proj``'s output with the conv weights, the gated norm's
sum of squares and the output's sum (tags ``ssm``, ``ssm-norm``).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import ROOT, load, run_world                 # noqa: E402
from test_torch_serve_session_tp import (B, G, REFERENCE, S,  # noqa: E402
                                         TOL, _top2)

from repro_torch.models.hybrid import group_layout            # noqa: E402

# the reference's steps on one device, for the bf16 cases' own distance
ONE_DEVICE = """
import dataclasses, json, pickle, sys
from pathlib import Path
import numpy as np, jax, jax.numpy as jnp
from repro.configs import SMOKE_ARCHS
from repro.models.api import build_model
from repro.runtime import serve as rt

root, G = Path(sys.argv[1]), int(sys.argv[3])
for sub, arch, compute, vocab in json.loads(sys.argv[2]):
    d = root / sub
    data = np.load(d / "inputs.npz")
    with open(d / "params.pkl", "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    model = build_model(dataclasses.replace(
        SMOKE_ARCHS[arch], compute_dtype=compute, vocab=vocab))
    B, S = data["tokens"].shape
    prefill = jax.jit(rt.make_prefill_step(model))
    decode = jax.jit(rt.make_decode_step(model))
    out = prefill(params, {"tokens": jnp.asarray(data["tokens"])},
                  model.init_cache(B, S + G, dtype=jnp.float32))
    logits = [np.asarray(out[0], np.float32)]
    carry = {"tokens": jnp.argmax(out[0][:, -1:, :], -1).astype(jnp.int32),
             "cache": out[1], "index": jnp.int32(S)}
    for _ in range(G - 1):
        lg, carry = decode(params, carry)
        logits.append(np.asarray(lg, np.float32))
    np.savez(d / "one_device.npz",
             **{f"logits{k}": l for k, l in enumerate(logits)})
print("OK")
"""

CASES_ = [("mamba2_f32", "mamba2-780m", "float32", 256),
          ("mamba2_bf16", "mamba2-780m", "bfloat16", 256),
          ("zamba2_f32", "zamba2-7b", "float32", 256),
          ("zamba2_bf16", "zamba2-7b", "bfloat16", 256)]
# world -> (accels, model_parallel, mesh)
WORLDS = {"2x2": (4, 2, {"data": 2, "model": 2}),
          "1x4": (4, 4, {"data": 1, "model": 4})}
CASES = [(w, c) for w in WORLDS for c in CASES_]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds at once beside the reference's subprocess: {world:
    [each rank's findings]}, and the reference's arrays by world and
    case."""
    import concurrent.futures
    root = tmp_path_factory.mktemp("serve_ssm")
    rng = np.random.default_rng(7)
    for sub, arch, _, vocab in CASES_:
        cfg = dataclasses.replace(SMOKE_ARCHS[arch], vocab=vocab)
        params = jax.tree.map(np.asarray, ref_build(cfg).init(
            jax.random.PRNGKey(0)))
        tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
        for w in WORLDS:
            d = root / f"{w}_{sub}"
            d.mkdir()
            with open(d / "params.pkl", "wb") as f:
                pickle.dump(params, f)
            np.savez(d / "inputs.npz", tokens=tokens)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(root),
         json.dumps([(mesh, [(f"{w}_{c[0]}",) + c[1:]
                             for c in CASES_ if c[1] == arch])]), str(G)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for w, (_, _, mesh) in WORLDS.items()
        for arch in ("mamba2-780m", "zamba2-7b")] + [subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(ONE_DEVICE), str(root),
             json.dumps([(f"{w}_{c[0]}",) + c[1:] for w in WORLDS
                         for c in CASES_ if c[2] == "bfloat16"]), str(G)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)]
    outs = []
    try:
        with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
            done = [pool.submit(
                run_world, 4, "serve_session", root / f"world_{w}",
                accels=accels, model_parallel=mp,
                cases=[(f"{w}_{c[0]}",) + c[1:] for c in CASES_], batch=B,
                prompt=S, generate=G, case_root=str(root))
                for w, (accels, mp, _) in WORLDS.items()]
            for f in done:
                f.result()
        outs = [ref.communicate(timeout=400)[0] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    for ref, out in zip(refs, outs):
        assert ref.returncode == 0 and "OK" in out, out[-3000:]
    ranks = {w: [load(root / f"world_{w}", "serve_session", r)
                 for r in range(4)] for w in WORLDS}
    reference = {}
    for w, c in CASES:
        d = root / f"{w}_{c[0]}"
        reference[(w, c[0])] = dict(np.load(d / "reference.npz"))
        if c[2] == "bfloat16":
            reference[(w, c[0])].update(
                {f"one_{k}": v for k, v in np.load(d / "one_device.npz")
                 .items()})
    return ranks, reference


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c[0]}" for w, c in CASES])
def test_session_equals_the_reference_sharded_steps(runs, world, case):
    ranks, reference = runs
    sub, arch, compute, vocab = case
    want = reference[(world, sub)]
    tol = TOL[compute]
    for r, rank in enumerate(ranks[world]):
        got = rank[f"{world}_{sub}"]
        assert got["grid"]["mesh"] == WORLDS[world][2]
        tokens = got["tokens"].numpy()
        live = np.ones(B, bool)             # rows not yet parted at a tie
        for step in range(G):
            ref = want[f"logits{step}"]
            lg = got["logits"][step].float().numpy()
            assert lg.shape == ref.shape == (B, 1, vocab), (lg.shape,
                                                            ref.shape)
            top = float(np.abs(ref).max())
            own = want.get(f"one_logits{step}", ref)
            bound = max(tol, 2 * float(np.abs(own - ref).max()) / top)
            err = float(np.abs(lg[live] - ref[live]).max())
            assert err <= bound * top, (r, step, err, bound)
            parted = live & (tokens[:, step] != want["tokens"][:, step])
            margins = [_top2(ref[i, -1]) for i in np.nonzero(parted)[0]]
            if any(mg > bound * top or compute == "float32"
                   for mg in margins):
                pytest.fail(f"{sub} rank {r} step {step}: tokens part at "
                            f"rows {np.nonzero(parted)[0].tolist()}, "
                            f"reference top-2 margins {margins} (C-ref3), "
                            f"bound {bound * top}")
            live &= ~parted
        assert live.sum() >= B - 1, (sub, r, live)


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c[0]}" for w, c in CASES])
def test_every_rank_holds_the_same_tokens_and_its_block(runs, world, case):
    """The carry's tokens are the same bits on every rank; each rank's
    cache holds its rows, its SSD heads, its heads' x channels with all
    of B and C, and its kv heads; the collectives are each step's greedy
    gathers, the embedding's and shared block's sums, and each mamba2
    layer's three."""
    ranks, _ = runs
    sub, arch, _, _ = case
    _, mp, mesh = WORLDS[world]
    data = mesh["data"]
    cfg = SMOKE_ARCHS[arch]
    name = f"{world}_{sub}"
    first = ranks[world][0][name]["tokens"]
    rows = B // data
    conv = (cfg.ssm_conv_width - 1,
            cfg.d_inner // mp + 2 * cfg.ssm_n_groups * cfg.ssm_state)
    ssd = (cfg.ssm_heads // mp, cfg.ssm_head_dim, cfg.ssm_state)
    if cfg.family == "ssm":
        mamba, shared = cfg.n_layers, 0
        want_cache = {"conv": (cfg.n_layers, rows) + conv,
                      "ssd": (cfg.n_layers, rows) + ssd}
    else:
        n_groups, per, tail = group_layout(cfg)
        mamba, shared = cfg.n_layers, n_groups
        kv = (n_groups, rows, S + G, cfg.n_kv_heads // mp, cfg.head_dim)
        want_cache = {"k": kv, "v": kv,
                      "conv": (n_groups, per, rows) + conv,
                      "ssd": (n_groups, per, rows) + ssd,
                      "conv_tail": (tail, rows) + conv,
                      "ssd_tail": (tail, rows) + ssd}
    for r, rank in enumerate(ranks[world]):
        got = rank[name]
        assert torch.equal(got["tokens"], first), r
        assert got["rows"] == (got["grid"]["coords"]["data"] * rows, rows)
        assert got["cache"] == want_cache, got["cache"]
        want = {"model:all-gather": G,
                "model:all-reduce": G * (1 + 2 * shared),
                "model:all-gather:ssm": G * mamba,
                "model:all-reduce:ssm": G * mamba,
                "model:all-reduce:ssm-norm": G * mamba}
        if data > 1:
            want["data:all-gather"] = G
        assert got["collectives"] == want, got["collectives"]
