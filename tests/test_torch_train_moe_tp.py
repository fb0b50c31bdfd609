"""Expert parallelism in training: the port's 4-rank ``(data 2, model
2)`` world against the reference's real sharded training step (an
``AxisType.Auto`` mesh of four forced host devices, in a subprocess),
FSDP off (the reference CLI's rules) and on, for olmoe-1b-7b smoke (8
experts, 4 a rank over ``model``) and mixtral-8x7b smoke (4 experts;
its 2 kv heads allow a model axis of 2 only), each in fp32 and bf16.
The rows split over ``data`` while the dispatch group and the
load-balancing loss stay the whole batch's, as the reference's one
group (``moe_groups=1``) under GSPMD.  Loss, grad norm and parameters at
``tests/test_torch_train_dist.TOL``, the replicated leaves (the router
without FSDP, the norms) equal in bits on every rank; the setup is
``tests/_train_tp_common.py``'s."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _train_tp_common as common                             # noqa: E402

LAYOUT = "2x2"
# (directory, arch, compute, vocab)
COMBOS = [("olmoe_f32", "olmoe-1b-7b", "float32", 256),
          ("olmoe_bf16", "olmoe-1b-7b", "bfloat16", 256),
          ("mixtral_f32", "mixtral-8x7b", "float32", 256),
          ("mixtral_bf16", "mixtral-8x7b", "bfloat16", 256)]
SUBS = [c[0] for c in COMBOS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.run_layout(tmp_path_factory.mktemp("train_moe_tp"),
                             LAYOUT, COMBOS)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_port_step_matches_reference_sharded_step(runs, sub, case):
    common.check_against_reference(runs, sub, case)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_replicated_leaves_and_repeats_in_bits(runs, sub, case):
    common.check_bits(runs, sub, case)
