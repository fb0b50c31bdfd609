"""The hybrid family under tensor parallelism and FSDP in training: the
port's 4-rank ``(data 2, model 2)`` world against the reference's real
sharded training step (an ``AxisType.Auto`` mesh of four forced host
devices, in a subprocess), FSDP off and on, zamba2-7b smoke (its shared
attention block's 4 heads, 2 a rank, its MLP column -> row, and the
mamba2 layers' 8 SSD heads, 4 a rank) in fp32 and bf16.  The checks are
``tests/test_torch_train_ssm_tp.py``'s."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _train_tp_common as common                             # noqa: E402

LAYOUT = "2x2"
# (directory, arch, compute, vocab)
COMBOS = [("zamba2_f32", "zamba2-7b", "float32", 256),
          ("zamba2_bf16", "zamba2-7b", "bfloat16", 256)]
SUBS = [c[0] for c in COMBOS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.run_layout(tmp_path_factory.mktemp("train_hybrid_tp"),
                             LAYOUT, COMBOS, ref_procs=2)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_port_step_matches_reference_sharded_step(runs, sub, case):
    common.check_against_reference(runs, sub, case)


@pytest.mark.parametrize("case", list(common.CASES[LAYOUT]))
@pytest.mark.parametrize("sub", SUBS)
def test_replicated_leaves_and_repeats_in_bits(runs, sub, case):
    common.check_bits(runs, sub, case)
