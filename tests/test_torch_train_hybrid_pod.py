"""The hybrid family under ScalePool's hierarchical gradient phase with
a ``model`` axis: the port's 4-rank ``(pod 2, data 1, model 2)`` world
against the reference's real sharded ``hierarchical`` step (an
``AxisType.Auto`` mesh of four forced host devices, in a subprocess),
with and without ``compress_pod``, zamba2-7b smoke in fp32 and bf16, and
the compressed step's residuals against the reference pod's (C-ref8).
A compressed fp32 run is held by the measured rule of C-port19: int8
codes flip on fp32 rounding, and zamba2's step-3 grad norm parts by
1.0e-5 between two of the reference's own programs of that schedule.
The combos are ``tests/test_torch_train_hybrid_tp.py``'s."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _train_tp_common as common                             # noqa: E402
from test_torch_train_hybrid_tp import COMBOS, SUBS           # noqa: E402

LAYOUT = "2x1x2"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.run_layout(tmp_path_factory.mktemp("train_hybrid_pod"),
                             LAYOUT, COMBOS, ref_procs=2)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_port_step_matches_reference_sharded_step(runs, sub, case):
    common.check_against_reference(runs, sub, case)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_replicated_leaves_and_repeats_in_bits(runs, sub, case):
    common.check_bits(runs, sub, case)


def test_compress_pod_residuals_match_the_reference_pod(runs):
    common.check_residuals(runs, "zamba2_f32", "compress_pod")
