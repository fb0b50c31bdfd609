"""The ssm family under tensor parallelism, FSDP and the hierarchical
gradient phase in training: the port's 4-rank worlds against the
reference's real sharded training steps (an ``AxisType.Auto`` mesh of
four forced host devices, in a subprocess), mamba2-780m smoke (8 SSD
heads, 4 a rank over ``model``) in fp32 and bf16:

* ``(data 2, model 2)``, FSDP off (the reference CLI's rules) and on;
* ``(pod 2, data 1, model 2)`` under ``hierarchical`` (``shard_map``
  manual over ``pod``, GSPMD on ``model``), with and without
  ``compress_pod``, and the compressed step's residuals against the
  reference pod's (C-ref8).

``in_proj``'s columns and the conv weights' channels are contiguous
blocks over ``model`` that are not head-aligned (``models/mamba2.py``);
the gated RMSNorm sums its squares over ``model``.  Loss, grad norm and
parameters at ``tests/test_torch_train_dist.TOL`` (fp32; a compressed
run by the measured rule of C-port19) or by the counted bf16 rule, and
the leaves ``model`` does not split (the norms) equal in bits on every
rank; the setup is ``tests/_train_tp_common.py``'s.  The hybrid
family's are ``tests/test_torch_train_hybrid_tp.py`` and
``tests/test_torch_train_hybrid_pod.py``."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _train_tp_common as common                             # noqa: E402

# (directory, arch, compute, vocab)
COMBOS = [("mamba2_f32", "mamba2-780m", "float32", 256),
          ("mamba2_bf16", "mamba2-780m", "bfloat16", 256)]
LAYOUTS = ("2x2", "2x1x2")
PARAMS = [(layout, c[0], case) for layout in LAYOUTS for c in COMBOS
          for case in common.CASES[layout]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {layout: common.run_layout(
        tmp_path_factory.mktemp(f"train_ssm_{layout}"), layout, COMBOS,
        ref_procs=2)
        for layout in LAYOUTS}


@pytest.mark.parametrize("layout,sub,case", PARAMS)
def test_port_step_matches_reference_sharded_step(runs, layout, sub, case):
    common.check_against_reference(runs[layout], sub, case)


@pytest.mark.parametrize("layout,sub,case", PARAMS)
def test_replicated_leaves_and_repeats_in_bits(runs, layout, sub, case):
    common.check_bits(runs[layout], sub, case)


def test_compress_pod_residuals_match_the_reference_pod(runs):
    common.check_residuals(runs["2x1x2"], "mamba2_f32", "compress_pod")
