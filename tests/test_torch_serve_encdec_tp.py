"""The encdec family's fixed-batch session under a ``model`` axis:
``runtime.serve.make_lease_session`` in worlds of 4 ranks over gloo
(``tests/_dist_world.py``), each rank serving its block of the rows, with
their frame embeddings and then their encoder states, on its heads of
whisper-small smoke (4 heads), against the reference's real
``make_prefill_step`` / ``make_decode_step`` jitted under
``use_rules(make_rules(..., fsdp=False), mesh)`` on an ``AxisType.Auto``
mesh of forced host devices, in a subprocess
(``tests/test_torch_serve_session_tp.py``'s).  Both start from the
reference's ``model.init(PRNGKey(0))`` (through numpy), the same numpy
prompts and frames (bf16): B=4 x 8 tokens, 4 generated (a prefill, 3
decode steps) over an fp32 cache, in fp32 and bf16 compute, on

* (data 2, model 2): rows over ``data``, 2 heads a rank;
* (data 1, model 4): every row, one head a rank.

Every step's logits, gathered from the ranks, lie within ``TOL`` of the
largest |logit| of the reference's, or within twice the reference's own
distance between its sharded and one-device steps where that is the
larger (ROADMAP C-port12's rule: in fp32 the reference's sharded
prefill parts from its one-device one by ~3.6e-5 of the largest); the
greedy tokens are identical but where the reference's top-2 margin lies
within that bound (a tie, C-ref3: the row then leaves the comparison),
and the same on every rank; each rank's cache holds its rows and kv
heads; the collectives are each step's greedy gathers and, under
``model``, the lookup's and three a decoder layer's sums (and the
prefill's two an encoder layer).  The serving
CLI's fixed-batch mode runs whisper on 4 ranks (the smoke mesh, data 2,
model 2): rank 0 prints the one-process summary (its tokens) plus
``world``, ``mesh`` and ``ranks_agree``.
"""

import concurrent.futures
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
from test_torch_train_ssm_cli import SERVE, _run, _torchrun   # noqa: E402

ARCH = "whisper-small"
# the reference's steps on one device, for its own distance
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
    out = prefill(params, {"tokens": jnp.asarray(data["tokens"]),
                           "frame_embeds": jnp.asarray(data["frames"],
                                                       jnp.bfloat16)},
                  model.init_cache(B, S + G, dtype=jnp.float32))
    logits = [np.asarray(out[0], np.float32)]
    carry = {"tokens": jnp.argmax(out[0][:, -1:, :], -1).astype(jnp.int32),
             "cache": out[1], "index": jnp.int32(S), "enc_states": out[2]}
    for _ in range(G - 1):
        lg, carry = decode(params, carry)
        logits.append(np.asarray(lg, np.float32))
    np.savez(d / "one_device.npz",
             **{f"logits{k}": l for k, l in enumerate(logits)})
print("OK")
"""

CASES_ = [("whisper_f32", ARCH, "float32", 256),
          ("whisper_bf16", ARCH, "bfloat16", 256)]
# world -> (accels, model_parallel, mesh)
WORLDS = {"2x2": (4, 2, {"data": 2, "model": 2}),
          "1x4": (4, 4, {"data": 1, "model": 4})}
CASES = [(w, c) for w in WORLDS for c in CASES_]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds and the two CLI runs at once beside the reference's
    subprocesses: ({world: [each rank's findings]}, the reference's
    arrays by world and case, {ranks: the CLI's (rc, stdout,
    stderr)})."""
    root = tmp_path_factory.mktemp("serve_encdec")
    rng = np.random.default_rng(9)
    cfg = SMOKE_ARCHS[ARCH]
    for sub, arch, _, vocab in CASES_:
        params = jax.tree.map(np.asarray, ref_build(dataclasses.replace(
            cfg, vocab=vocab)).init(jax.random.PRNGKey(0)))
        arrays = {"tokens": rng.integers(1, vocab, (B, S)).astype(np.int32),
                  "frames": rng.standard_normal(
                      (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
        for w in WORLDS:
            d = root / f"{w}_{sub}"
            d.mkdir()
            with open(d / "params.pkl", "wb") as f:
                pickle.dump(params, f)
            np.savez(d / "inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    named = [(f"{w}_{c[0]}",) + c[1:] for w in WORLDS for c in CASES_]
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(root),
         json.dumps([(mesh, [(f"{w}_{c[0]}",) + c[1:] for c in CASES_])]),
         str(G)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for w, (_, _, mesh) in WORLDS.items()] + [
        subprocess.Popen([sys.executable, "-c", textwrap.dedent(ONE_DEVICE),
                          str(root), json.dumps(named), str(G)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)]
    outs = []
    cli = [["--arch", ARCH] + SERVE]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(WORLDS) + 1) as pool:
            done = [pool.submit(
                run_world, 4, "serve_session", root / f"world_{w}",
                accels=accels, model_parallel=mp,
                cases=[(f"{w}_{c[0]}",) + c[1:] for c in CASES_], batch=B,
                prompt=S, generate=G, case_root=str(root))
                for w, (accels, mp, _) in WORLDS.items()]
            clis = pool.submit(_run, [
                [sys.executable, "-m", "repro_torch.launch.serve"] + cli[0],
                _torchrun(4, "repro_torch.launch.serve", cli[0])])
            for f in done:
                f.result()
            clis = dict(zip((1, 4), clis.result()))
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
        reference[(w, c[0])].update(
            {f"one_{k}": v for k, v in np.load(d / "one_device.npz").items()})
    return ranks, reference, clis


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"{w}-{c[0]}" for w, c in CASES])
def test_session_equals_the_reference_sharded_steps(runs, world, case):
    ranks, reference, _ = runs
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
            own = want[f"one_logits{step}"]
            bound = max(tol, 2 * float(np.abs(own - ref).max()) / top)
            err = float(np.abs(lg[live] - ref[live]).max())
            assert err <= bound * top, (r, step, err, bound)
            parted = live & (tokens[:, step] != want["tokens"][:, step])
            margins = [_top2(ref[i, -1]) for i in np.nonzero(parted)[0]]
            if any(mg > bound * top for mg in margins):
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
    cache holds its rows and kv heads; the collectives are each step's
    greedy gathers, the lookup's sum and each decoder layer's three, and
    in the prefill each encoder layer's two."""
    ranks, _, _ = runs
    sub = case[0]
    _, mp, mesh = WORLDS[world]
    cfg = SMOKE_ARCHS[ARCH]
    rows = B // mesh["data"]
    name = f"{world}_{sub}"
    first = ranks[world][0][name]["tokens"]
    kv = (cfg.n_layers, rows, S + G, cfg.n_kv_heads // mp, cfg.head_dim)
    for r, rank in enumerate(ranks[world]):
        got = rank[name]
        assert torch.equal(got["tokens"], first), r
        assert got["rows"] == (got["grid"]["coords"]["data"] * rows, rows)
        assert got["cache"] == {"k": kv, "v": kv}, got["cache"]
        want = {"model:all-gather": G,
                "model:all-reduce": G * (1 + 3 * cfg.n_layers)
                + 2 * cfg.n_enc_layers}
        if mesh["data"] > 1:
            want["data:all-gather"] = G
        assert got["collectives"] == want, got["collectives"]


def test_serving_cli_across_ranks_prints_the_one_process_run(runs):
    clis = runs[2]
    (rc1, out1, err1), (rc4, out4, err4) = clis[1], clis[4]
    assert rc1 == 0, err1[-3000:]
    assert rc4 == 0, err4[-3000:]
    a, b = json.loads(out1), json.loads(out4)
    assert b.pop("world") == 4
    assert b.pop("mesh") == {"data": 2, "model": 2}
    assert b.pop("ranks_agree") is True
    for d in (a, b):
        for key in ("wall_s", "prefill_s", "decode_tok_per_s"):
            d.pop(key, None)
    assert b == a
