"""Tensor parallelism and FSDP: the port's 4-rank ``(data 2, model 2)``
world against the reference's real sharded training step, FSDP off (the
reference CLI's rules) and on (``make_rules``' default).  The setup,
tolerances and combos are in ``tests/_train_tp_common.py``."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _train_tp_common as common                             # noqa: E402

LAYOUT = "2x2"
SUBS = [c[0] for c in common.COMBOS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.run_layout(tmp_path_factory.mktemp("train_tp"), LAYOUT)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_port_step_matches_reference_sharded_step(runs, sub, case):
    common.check_against_reference(runs, sub, case)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_replicated_leaves_and_repeats_in_bits(runs, sub, case):
    common.check_bits(runs, sub, case)
