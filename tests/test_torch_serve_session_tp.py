"""The fixed-batch session on a lease's grid: ``runtime.serve.
make_lease_session`` in a world of ranks over gloo (``tests/
_dist_world.py``, one thread a rank), each rank serving its block of
the rows on its shards of the model, against the reference's real
``make_prefill_step`` / ``make_decode_step`` jitted under
``use_rules(make_rules(..., fsdp=False), mesh)`` on an ``AxisType.Auto``
mesh of forced host devices, in a subprocess (the reference's own
``make_lease_session`` stops at C-ref1).  Both start from the
reference's ``model.init(PRNGKey(0))`` (through numpy) and the same
numpy prompts: B=4 x 8 tokens, 4 generated (a prefill, 3 decode steps)
over an fp32 cache.

Worlds:

* (data 2, model 2): qwen1.5-0.5b smoke (4 heads, 4 kv heads, 2 layers)
  at vocab 256, rows over ``data`` and heads over ``model``, and
  olmoe-1b-7b smoke, its experts over ``model`` too, its dispatch group
  the whole batch (the reference's one group);
* (data 1, model 4): qwen at vocab 250, its table padded to 256 rows,
  whose last rank holds padded columns;
  each in fp32 and bf16 compute;
* (pod 2, data 1, model 2): a lease of 12 accelerators spanning two
  pods, qwen in fp32, rows over ``pod``;
* (data 2, model 1): mamba2-780m, zamba2-7b and whisper-small smoke in
  fp32, rows only (whisper's frames drawn in bf16).

Every step's logits, gathered from the ranks, are within ``TOL`` of the
largest |logit| of the reference's; the greedy tokens are identical (a
divergence reports the reference's top-2 margin there, C-ref3) and the
same on every rank; each rank's cache holds its rows and kv heads; the
collectives are the greedy token's gathers over ``data`` and the
model's over ``model``.
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

from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402

B, S, G = 4, 8, 4
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# world -> (accels, model_parallel, mesh, [(directory, arch, compute,
# vocab)])
WORLDS = {
    "2x2": (4, 2, {"data": 2, "model": 2},
            [("qwen_f32", "qwen1.5-0.5b", "float32", 256),
             ("qwen_bf16", "qwen1.5-0.5b", "bfloat16", 256),
             ("olmoe_f32", "olmoe-1b-7b", "float32", 256),
             ("olmoe_bf16", "olmoe-1b-7b", "bfloat16", 256)]),
    "1x4": (4, 4, {"data": 1, "model": 4},
            [("qwen250_f32", "qwen1.5-0.5b", "float32", 250),
             ("qwen250_bf16", "qwen1.5-0.5b", "bfloat16", 250)]),
    "2x1x2": (12, 2, {"pod": 2, "data": 1, "model": 2},
              [("qwen_pod_f32", "qwen1.5-0.5b", "float32", 256)]),
    "2x1": (2, 1, {"data": 2, "model": 1},
            [("mamba2_f32", "mamba2-780m", "float32", 256),
             ("zamba2_f32", "zamba2-7b", "float32", 256),
             ("whisper_f32", "whisper-small", "float32", 256)]),
}
CASES = [(w, c) for w, (_, _, _, cs) in WORLDS.items() for c in cs]

REFERENCE = """
import dataclasses, json, pickle, sys
from pathlib import Path
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import SMOKE_ARCHS
from repro.core.compat import mesh_context
from repro.models.api import build_model
from repro.models.config import ShapeConfig
from repro.runtime import serve as rt
from repro.sharding.partition import use_rules
from repro.sharding.profiles import make_rules

root = Path(sys.argv[1])
G = int(sys.argv[3])
for mesh_, cases in json.loads(sys.argv[2]):
    axes = tuple(mesh_)
    shape_ = tuple(mesh_.values())
    n = int(np.prod(shape_))
    mesh = jax.make_mesh(shape_, axes,
                         axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n])
    for sub, arch, compute, vocab in cases:
        d = root / sub
        data = np.load(d / "inputs.npz")
        with open(d / "params.pkl", "rb") as f:
            params = jax.tree.map(jnp.asarray, pickle.load(f))
        cfg = dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype=compute,
                                  vocab=vocab)
        model = build_model(cfg)
        B, S = data["tokens"].shape
        rules = make_rules(cfg, ShapeConfig("s", "decode", S + G, B), mesh,
                           fsdp=False)
        prefill = jax.jit(rt.make_prefill_step(model))
        decode = jax.jit(rt.make_decode_step(model))
        with use_rules(rules, mesh), mesh_context(mesh):
            cache = model.init_cache(B, S + G, dtype=jnp.float32)
            batch = {"tokens": jnp.asarray(data["tokens"])}
            if "frames" in data:
                batch["frame_embeds"] = jnp.asarray(data["frames"],
                                                    jnp.bfloat16)
            out = prefill(params, batch, cache)
            logits = [np.asarray(out[0], np.float32)]
            carry = {"tokens": jnp.argmax(out[0][:, -1:, :], -1)
                     .astype(jnp.int32), "cache": out[1],
                     "index": jnp.int32(S)}
            if len(out) > 2:
                carry["enc_states"] = out[2]
            tokens = [np.asarray(carry["tokens"])]
            for _ in range(G - 1):
                lg, carry = decode(params, carry)
                logits.append(np.asarray(lg, np.float32))
                tokens.append(np.asarray(carry["tokens"]))
        np.savez(d / "reference.npz", tokens=np.concatenate(tokens, 1),
                 **{f"logits{k}": l for k, l in enumerate(logits)})
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world at once beside the reference's subprocess: {world:
    [each rank's findings]}, and the reference's arrays by case."""
    import concurrent.futures
    root = tmp_path_factory.mktemp("serve_session")
    rng = np.random.default_rng(5)
    for _, (_, _, _, cases) in WORLDS.items():
        for sub, arch, _, vocab in cases:
            d = root / sub
            d.mkdir()
            cfg = dataclasses.replace(SMOKE_ARCHS[arch], vocab=vocab)
            with open(d / "params.pkl", "wb") as f:
                pickle.dump(jax.tree.map(np.asarray, ref_build(cfg).init(
                    jax.random.PRNGKey(0))), f)
            arrays = {"tokens": rng.integers(1, vocab, (B, S))
                      .astype(np.int32)}
            if cfg.family == "encdec":
                arrays["frames"] = rng.standard_normal(
                    (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
            np.savez(d / "inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(root),
         json.dumps([(mesh, cases) for _, _, mesh, cases in WORLDS.values()]),
         str(G)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
            done = {w: pool.submit(
                run_world, int(np.prod(list(mesh.values()))),
                "serve_session", root / f"world_{w}", accels=accels,
                model_parallel=mp, cases=cases, batch=B, prompt=S,
                generate=G, case_root=str(root))
                for w, (accels, mp, mesh, cases) in WORLDS.items()}
            for f in done.values():
                f.result()
        out, _ = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "OK" in out, out[-3000:]
    ranks = {w: [load(root / f"world_{w}", "serve_session", r)
                 for r in range(int(np.prod(list(mesh.values()))))]
             for w, (_, _, mesh, _) in WORLDS.items()}
    reference = {c[0]: dict(np.load(root / c[0] / "reference.npz"))
                 for _, c in CASES}
    return ranks, reference


def _top2(logits: np.ndarray) -> float:
    top = np.sort(logits.astype(np.float64))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c[0]}" for w, c in CASES])
def test_session_equals_the_reference_sharded_steps(runs, world, case):
    ranks, reference = runs
    sub, arch, compute, vocab = case
    want = reference[sub]
    tol = TOL[compute]
    for r, rank in enumerate(ranks[world]):
        got = rank[sub]
        assert rank[sub]["grid"]["mesh"] == WORLDS[world][2]
        tokens = got["tokens"].numpy()
        for step in range(G):
            ref = want[f"logits{step}"]
            lg = got["logits"][step].float().numpy()
            assert lg.shape == ref.shape == (B, 1, vocab), (lg.shape,
                                                            ref.shape)
            err = float(np.abs(lg - ref).max())
            assert err <= tol * float(np.abs(ref).max()), (r, step, err)
            if not np.array_equal(tokens[:, step], want["tokens"][:, step]):
                rows = np.nonzero(tokens[:, step] != want["tokens"][:, step])
                margins = [_top2(ref[i, -1]) for i in rows[0]]
                pytest.fail(f"{sub} rank {r} step {step}: tokens part at "
                            f"rows {rows[0].tolist()}, reference top-2 "
                            f"margins {margins} (C-ref3)")


@pytest.mark.parametrize("world", list(WORLDS))
def test_every_rank_holds_the_same_tokens_and_its_block(runs, world):
    """The carry's tokens are the same bits on every rank; each rank's
    cache holds its rows (the rules' ``batch`` over ``data``) and, under
    ``model``, its kv heads; the collectives are each step's greedy
    gathers and the model's all-reduces."""
    ranks, _ = runs
    accels, mp, mesh, cases = WORLDS[world]
    pods = mesh.get("pod", 1)
    data = pods * mesh["data"]
    for sub, arch, _, _ in cases:
        cfg = SMOKE_ARCHS[arch]
        first = ranks[world][0][sub]["tokens"]
        for r, rank in enumerate(ranks[world]):
            got = rank[sub]
            assert torch.equal(got["tokens"], first), (sub, r)
            coords = got["grid"]["coords"]
            block = coords.get("pod", 0) * mesh["data"] + coords["data"]
            assert got["rows"] == (block * B // data, B // data)
            assert got["rules_batch"] == (("pod", "data") if pods > 1
                                          else "data")
            if cfg.family in ("dense", "moe"):
                want_kv = (cfg.n_layers, B // data, S + G,
                           cfg.n_kv_heads // mp, cfg.head_dim)
                assert got["cache"] == {"k": want_kv, "v": want_kv}
            else:
                one = build_model(get_config(arch, smoke=True),
                                  device="cpu").init_cache(
                    B // data, S + G, dtype=torch.float32)
                assert got["cache"] == {k: tuple(v.shape)
                                        for k, v in one.items()}, sub
            calls = got["collectives"]
            want = {}
            rows_over = "+".join(a for a in ("pod", "data")
                                 if mesh.get(a, 1) > 1)
            moe = cfg.family == "moe"
            if rows_over:
                want[f"{rows_over}:all-gather"] = G
                if moe:                 # each layer's entries' experts
                    want[f"{rows_over}:all-gather:moe-experts"] = \
                        G * cfg.n_layers
            if mp > 1:
                want["model:all-gather"] = G
                want["model:all-reduce"] = G * (1 + (2 - moe) * cfg.n_layers)
                if moe:                 # each expert layer's sum
                    want["model:all-reduce:moe"] = G * cfg.n_layers
            assert calls == want, (sub, calls)
