"""C-port14: a step that fails on one rank of a grid restarts the world.

The training CLI under ``python -m torch.distributed.run --standalone
--max-restarts 1`` on 4 CPU ranks, tensor parallel on the reference's
smoke mesh (data 2, model 2), ``--ckpt-every 1``, through a wrapper that
calls the CLI's ``main`` with a failure hook raising on rank 1 before
step 2 of the first attempt only (``TORCHELASTIC_RESTART_COUNT ==
0``).  The failed rank's process ends; the agent stops the others and
re-forms the world; every rank restores the last checkpoint this run
committed and the loop rewinds to its step.  Held against an unfailed
run of the same command: exit 0, the resume reported, the replayed
steps' losses in the same bits as the first attempt's and the
unfailed run's, and the final checkpoint (params, mu, nu) equal in bits.
Each ``torch.distributed.run`` is killed past its time limit.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _dist_world import WORLD_TIMEOUT_S                       # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
STEPS, FAIL_AT = 4, 2

WRAPPER = f"""
import os, sys
from repro_torch.launch.train import main

def hook(step):
    if (os.environ["TORCHELASTIC_RESTART_COUNT"] == "0"
            and os.environ["RANK"] == "1" and step == {FAIL_AT}):
        raise RuntimeError("injected failure on rank 1 at step {FAIL_AT}")

raise SystemExit(main(sys.argv[1:], failure_hook=hook))
"""


def _torchrun(target, argv, restarts):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "--max-restarts", str(restarts), *target,
         "--smoke", "--device", "cpu", "--steps", str(STEPS), "--batch", "8",
         "--seq", "32", "--ckpt-every", "1", "--log-every", "1", *argv],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"torch.distributed.run {argv} overran "
                             f"{WORLD_TIMEOUT_S} s")
    return proc.returncode, out, err


def _losses(err):
    """[(step, loss)] from rank 0's per-step lines on stderr, in order."""
    out = []
    for line in err.splitlines():
        if line.startswith('{"step"'):
            d = json.loads(line)
            out.append((d["step"], d["loss"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("restart")
    (d / "wrapper.py").write_text(textwrap.dedent(WRAPPER))
    plain = _torchrun(["-m", "repro_torch.launch.train"],
                      ["--ckpt-dir", str(d / "plain")], 0)
    failed = _torchrun([str(d / "wrapper.py")],
                       ["--ckpt-dir", str(d / "failed")], 1)
    return d, plain, failed


def test_the_failed_world_restarts_and_resumes(runs):
    _, (rc0, out0, err0), (rc, out, err) = runs
    assert rc0 == 0, err0[-3000:]
    assert rc == 0, err[-3000:]
    assert f"injected failure on rank 1 at step {FAIL_AT}" in err
    summary = json.loads(out)
    plain = json.loads(out0)
    assert summary["restarts"] == 1 and plain["restarts"] == 0
    assert plain["resumed_from"] is None
    # the last checkpoint committed before the failure: step FAIL_AT's,
    # or step FAIL_AT - 1's where the stop cut short rank 0's thread
    # writing the former (the latter had all of step FAIL_AT to finish)
    assert summary["resumed_from"] in (FAIL_AT - 1, FAIL_AT)
    assert "restored the checkpoint of step" in err
    assert summary["mesh"] == {"data": 2, "model": 2}
    assert summary["loss_first"] == plain["loss_first"]
    assert summary["loss_last"] == plain["loss_last"]


def test_replayed_steps_give_the_same_bits(runs):
    _, (_, _, err0), (_, out, err) = runs
    want = dict(_losses(err0))
    assert sorted(want) == list(range(1, STEPS + 1))
    got = _losses(err)
    resumed = json.loads(out)["resumed_from"]
    # the first attempt's steps, then the restarted world's
    first = [s for s, _ in got[:FAIL_AT]]
    assert first == list(range(1, FAIL_AT + 1))
    assert [s for s, _ in got[FAIL_AT:]] == list(range(resumed + 1,
                                                       STEPS + 1))
    for step, loss in got:
        assert loss == want[step], step


def test_final_state_equals_the_unfailed_run_in_bits(runs):
    d, _, _ = runs
    a, b = d / "plain" / f"step{STEPS}", d / "failed" / f"step{STEPS}"
    ma = json.loads((a / "manifest.p0.json").read_text())
    mb = json.loads((b / "manifest.p0.json").read_text())
    assert ma["leaves"].keys() == mb["leaves"].keys()
    n = 0
    for name, meta in ma["leaves"].items():
        for ea, eb in zip(meta["shards"], mb["leaves"][name]["shards"]):
            assert ea["index"] == eb["index"]
            assert np.array_equal(np.load(a / ea["file"]),
                                  np.load(b / eb["file"])), name
            n += 1
    assert n > 0
