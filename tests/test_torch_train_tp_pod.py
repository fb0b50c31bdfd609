"""Tensor parallelism under ScalePool's hierarchical gradient phase: the
port's 4-rank ``(pod 2, data 1, model 2)`` world against the reference's
real sharded ``hierarchical`` step (``shard_map`` manual over ``pod``,
GSPMD on ``model``), with and without ``compress_pod``, and the
compressed step's residuals against the reference pod's (C-ref8).  The
setup, tolerances and combos are in ``tests/_train_tp_common.py``."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _train_tp_common as common                             # noqa: E402

LAYOUT = "2x1x2"
SUBS = [c[0] for c in common.COMBOS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.run_layout(tmp_path_factory.mktemp("train_tp_pod"),
                             LAYOUT)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_port_step_matches_reference_sharded_step(runs, sub, case):
    common.check_against_reference(runs, sub, case)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_replicated_leaves_and_repeats_in_bits(runs, sub, case):
    common.check_bits(runs, sub, case)


@pytest.mark.parametrize("sub", [s for s in SUBS if s.endswith("f32")])
def test_compress_pod_residuals_match_the_reference_pod(runs, sub):
    common.check_residuals(runs, sub, "compress_pod")
