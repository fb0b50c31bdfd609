"""The ssm and hybrid families through the CLIs across ranks on the CPU
(``torch.distributed.run`` over gloo), against one process:

* the training CLI on a lease of 2 accelerators with
  ``--pool-model-parallel 2`` (data 1, model 2: the mamba2 block's SSD
  heads and zamba2's shared attention heads over ``model``), mamba2-780m
  and zamba2-7b smoke (bf16 compute, lr 1e-3): the first and last
  losses within
  the bf16 loss tolerance of ``tests/test_torch_train_dist.py`` (2e-2
  relative) of one process training the same lease;
* the serving CLI's fixed-batch mode on 4 ranks (the smoke mesh, data 2,
  model 2): rank 0 prints the one-process summary (tokens included)
  plus ``world``, ``mesh`` and ``ranks_agree``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("mamba2-780m", "zamba2-7b")
# lr 1e-3: zamba2 smoke's loss rises over 3 steps at the CLI's default
TRAIN = ["--steps", "3", "--batch", "8", "--seq", "32", "--lr", "1e-3",
         "--pool",
         "scalepool", "--pool-accels", "2", "--pool-model-parallel", "2"]
SERVE = ["--smoke", "--batch", "8", "--prompt", "16", "--generate", "6",
         "--device", "cpu"]
TIMEOUT_S = 150


def _run(cmds):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT), env=env) for c in cmds]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _torchrun(n, module, argv):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n), "-m", module] + argv


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """Every CLI run at once: {(arch, "train" or "serve", ranks): (rc,
    stdout, stderr)}."""
    d = tmp_path_factory.mktemp("ssm_cli")
    keys, cmds = [], []
    for arch in ARCHS:
        for n in (1, 2):
            argv = ["--arch", arch, "--smoke", "--device", "cpu", *TRAIN,
                    "--ckpt-dir", str(d / f"{arch}_{n}")]
            keys.append((arch, "train", n))
            cmds.append(_torchrun(n, "repro_torch.launch.train", argv) if n > 1
                        else [sys.executable, "-m",
                              "repro_torch.launch.train"] + argv)
        for n in (1, 4):
            argv = ["--arch", arch] + SERVE
            keys.append((arch, "serve", n))
            cmds.append(_torchrun(n, "repro_torch.launch.serve", argv) if n > 1
                        else [sys.executable, "-m",
                              "repro_torch.launch.serve"] + argv)
    return dict(zip(keys, _run(cmds)))


@pytest.mark.parametrize("arch", ARCHS)
def test_training_cli_on_a_model_axis_trains_as_one_process(clis, arch):
    (rc1, out1, err1), (rc2, out2, err2) = (clis[(arch, "train", 1)],
                                            clis[(arch, "train", 2)])
    assert rc1 == 0, err1[-3000:]
    assert rc2 == 0, err2[-3000:]
    one, two = json.loads(out1), json.loads(out2)
    assert two["mesh"] == {"data": 1, "model": 2} and two["world"] == 2
    assert "ssm_heads=model" in two["rules"]
    assert one["devices"] == 1
    for key in ("loss_first", "loss_last"):
        assert abs(two[key] - one[key]) <= 2e-2 * abs(one[key]), key
    assert two["loss_drop"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_cli_across_ranks_prints_the_one_process_run(clis, arch):
    (rc1, out1, err1), (rc4, out4, err4) = (clis[(arch, "serve", 1)],
                                            clis[(arch, "serve", 4)])
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
