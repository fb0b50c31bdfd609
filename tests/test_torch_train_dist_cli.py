"""Elastic re-planning and the distributed training CLI, on the CPU.

``ckpt.elastic.replan``: fp32 ``auto`` on a 4-rank ``(pod 2, data 2,
model 1)`` gloo world (``tests/_dist_world.py``) trains 2 steps from the
reference's ``model.init(PRNGKey(0))`` (olmo-1b smoke), rank 0
checkpoints, and the world takes a third step; worlds of 2 ranks and of
1 restore the checkpoint (the same state in bits) and take that third
step, which matches the uninterrupted one: loss and grad norm to 1e-5
relative, parameters to 1e-5 of the largest |parameter| (AdamW's
near-zero-gradient elements aside, as ``tests/test_torch_train_dist.py``
states).

The CLI under ``python -m torch.distributed.run --standalone`` on
``--device cpu --smoke``: 4 ranks on the lease's (2, 2, 1) layout with
``--dp-mode hierarchical --compress-pod`` exit 0 with rank 0's summary;
a one-pod lease falls back to ``auto`` with a warning; 4 ranks without
``--pool`` train with tensor parallelism on the reference's smoke mesh
(data 2, model 2), as the reference's CLI does, and so does
``--pool-model-parallel 2`` on the lease's (pod 2, data 1, model 2);
the moe family under a ``model`` axis, or a layout the world does not
fill, exits 2 with the reason before any process group is made.  Every
world and every ``torch.distributed.run`` is killed past its time
limit.
"""

import ast
import json
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _dist_ranks                                            # noqa: E402
from _dist_world import WORLD_TIMEOUT_S, load, run_world      # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = "olmo-1b"


@pytest.fixture(scope="module")
def replan(tmp_path_factory):
    """{world: what it restored and its third step} and the writer's."""
    d = tmp_path_factory.mktemp("replan")
    params = ref_build(SMOKE_ARCHS[ARCH]).init(jax.random.PRNGKey(0))
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    rng = np.random.default_rng(3)
    vocab = SMOKE_ARCHS[ARCH].vocab
    np.savez(d / "inputs.npz",
             tokens=rng.integers(0, vocab, (3, 8, 32)).astype(np.int32),
             labels=rng.integers(0, vocab, (3, 8, 32)).astype(np.int32))
    run_world(4, "replan_write", d, arch=ARCH)
    run_world(2, "replan_read", d, arch=ARCH)
    # a world of one makes no process group: run it here
    env = {"RANK": "0", "WORLD_SIZE": "1", "DIST_INIT": "unused"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        _dist_ranks.replan_read(str(d), arch=ARCH)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return {"writer": load(d, "replan_write", 0),
            2: [load(d, "replan_read2", r) for r in range(2)],
            1: [load(d, "replan_read1", 0)]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("world", [2, 1])
def test_replan_restores_the_checkpoint_in_bits(replan, world):
    want = _leaves(replan["writer"]["at2"])
    for rank in replan[world]:
        assert rank["step"] == 2
        got = _leaves(rank["restored"])
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("world", [2, 1])
def test_step_after_replan_matches_the_uninterrupted_run(replan, world):
    want = replan["writer"]
    wp = [t.numpy() for t in _leaves(want["params3"])]
    top = max(np.abs(t).max() for t in wp)
    for rank in replan[world]:
        for name in ("loss", "grad_norm"):
            assert abs(rank["metrics3"][name] - want["metrics3"][name]) \
                <= 1e-5 * abs(want["metrics3"][name]), name
        assert rank["metrics3"]["step"] == 3
        off = n = 0
        for a, b in zip(_leaves(rank["params3"]), wp):
            err = np.abs(a.numpy() - b)
            assert err.max() <= 2 * _dist_ranks.LR
            off += int((err > 1e-5 * top).sum())
            n += err.size
        assert off <= 1e-3 * n, (off, n)


def _torchrun(nproc, argv, timeout=WORLD_TIMEOUT_S):
    """``python -m torch.distributed.run --standalone`` of the training
    CLI on the CPU; its process group is killed past ``timeout``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", *argv],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"torch.distributed.run {argv} overran "
                             f"{timeout} s")
    return proc.returncode, out, err


def _reference_cli_keys():
    tree = ast.parse((ROOT / "src/repro/launch/train.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "emit_json"):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no emit_json call in the reference CLI")


def test_cli_trains_hierarchical_on_four_ranks(tmp_path):
    rc, out, err = _torchrun(4, [
        "--pool", "scalepool", "--pool-accels", "12", "--dp-mode",
        "hierarchical", "--compress-pod", "--steps", "3", "--batch", "8",
        "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert rc == 0, err[-3000:]
    summary = json.loads(out)      # rank 0 alone prints
    assert list(summary) == _reference_cli_keys() + [
        "device", "world", "compress_pod", "backend", "rules",
        "resumed_from"]
    assert summary["mesh"] == {"pod": 2, "data": 2, "model": 1}
    assert summary["dp_mode"] == "hierarchical"
    assert summary["compress_pod"] is True
    assert summary["backend"] == "gloo" and summary["world"] == 4
    assert summary["devices"] == 4 and summary["device"] == "cpu"
    assert summary["loss_drop"] > 0 and summary["restarts"] == 0
    assert "backend: gloo" in err


def test_cli_falls_back_to_auto_without_a_pod_axis(tmp_path):
    rc, out, err = _torchrun(4, [
        "--pool", "scalepool", "--pool-accels", "4", "--dp-mode",
        "hierarchical", "--steps", "2", "--batch", "8", "--seq", "32",
        "--ckpt-dir", str(tmp_path)])
    assert rc == 0, err[-3000:]
    summary = json.loads(out)
    assert summary["mesh"] == {"data": 4, "model": 1}
    assert summary["dp_mode"] == "auto"
    assert "falling back to dp_mode=auto" in err


def test_cli_refuses_a_model_axis_before_the_loop(tmp_path):
    """Without a lease, 4 ranks take the reference's smoke mesh (2, 2)
    over (data, model): the moe family under tensor parallelism (expert
    parallelism is a later slice), refused with exit 2."""
    rc, _, err = _torchrun(4, ["--arch", "olmoe-1b-7b", "--steps", "2",
                               "--ckpt-dir", str(tmp_path)])
    assert rc != 0
    assert "tensor parallelism" in err and "exitcode  : 2" in err
    assert "expert parallelism" in err and "later slice" in err


@pytest.mark.parametrize("argv,mesh", [
    ([], {"data": 2, "model": 2}),
    (["--pool", "scalepool", "--pool-accels", "12", "--pool-model-parallel",
      "2"], {"pod": 2, "data": 1, "model": 2})])
def test_cli_trains_tensor_parallel_on_four_ranks(tmp_path, argv, mesh):
    """The reference CLI's own default on 4 devices: tensor parallelism
    with ``make_rules(..., fsdp=False)``."""
    rc, out, err = _torchrun(4, argv + [
        "--steps", "3", "--batch", "8", "--seq", "32", "--ckpt-dir",
        str(tmp_path)])
    assert rc == 0, err[-3000:]
    summary = json.loads(out)
    assert summary["mesh"] == mesh and summary["world"] == 4
    assert summary["dp_mode"] == "auto" and summary["backend"] == "gloo"
    assert "heads=model" in summary["rules"]
    assert "embed=" not in summary["rules"]         # FSDP off
    assert summary["resumed_from"] is None and summary["restarts"] == 0
    assert summary["loss_drop"] > 0


@pytest.mark.parametrize("world,argv,reason", [
    ("4", ["--arch", "olmoe-1b-7b"], "tensor parallelism"),
    ("2", [], "does not fill the layout"),
    ("4", ["--pool", "scalepool", "--pool-accels", "12",
           "--pool-model-parallel", "2", "--arch", "mamba2-780m"],
     "tensor parallelism")])
def test_cli_layout_refusals_exit_2(monkeypatch, capsys, tmp_path, world,
                                    argv, reason):
    from repro_torch.launch.train import main
    monkeypatch.setenv("WORLD_SIZE", world)
    monkeypatch.setenv("RANK", "0")
    rc = main(["--smoke", "--device", "cpu", "--steps", "1", "--ckpt-dir",
               str(tmp_path)] + argv)
    assert rc == 2 and reason in capsys.readouterr().err
