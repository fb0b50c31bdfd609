"""The encdec family under tensor parallelism, FSDP and the
hierarchical gradient phase in training: the port's 4-rank worlds
against the reference's real sharded training steps (an
``AxisType.Auto`` mesh of four forced host devices, in a subprocess),
whisper-small smoke (4 heads, 2 a rank over ``model``) in fp32 and bf16,
each batch carrying the stub frontend's ``frame_embeds`` (split by rows
as ``tokens`` are, the reference's ``batch_shardings``):

* ``(data 2, model 2)``, FSDP off (the reference CLI's rules) and on;
* ``(pod 2, data 1, model 2)`` under ``hierarchical`` (``shard_map``
  manual over ``pod``, GSPMD on ``model``), with and without
  ``compress_pod``, and the compressed step's residuals against the
  reference pod's (C-ref8).

Each attention runs the rank's heads, the decoder's cross K/V from
encoder states behind one ``copy_to_model``.  Loss, grad norm and
parameters at ``tests/test_torch_train_dist.TOL`` (fp32) or by the
counted bf16 rule, and the leaves ``model`` does not split (the
LayerNorms) equal in bits on every rank; the setup is
``tests/_train_tp_common.py``'s."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _train_tp_common as common                             # noqa: E402

# (directory, arch, compute, vocab)
COMBOS = [("whisper_f32", "whisper-small", "float32", 256),
          ("whisper_bf16", "whisper-small", "bfloat16", 256)]
LAYOUTS = ("2x2", "2x1x2")
PARAMS = [(layout, c[0], case) for layout in LAYOUTS for c in COMBOS
          for case in common.CASES[layout]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {layout: common.run_layout(
        tmp_path_factory.mktemp(f"train_encdec_{layout}"), layout, COMBOS,
        ref_procs=2)
        for layout in LAYOUTS}


@pytest.mark.parametrize("layout,sub,case", PARAMS)
def test_port_step_matches_reference_sharded_step(runs, layout, sub, case):
    common.check_against_reference(runs[layout], sub, case)


@pytest.mark.parametrize("layout,sub,case", PARAMS)
def test_replicated_leaves_and_repeats_in_bits(runs, layout, sub, case):
    common.check_bits(runs[layout], sub, case)


def test_compress_pod_residuals_match_the_reference_pod(runs):
    common.check_residuals(runs["2x1x2"], "whisper_f32", "compress_pod")
