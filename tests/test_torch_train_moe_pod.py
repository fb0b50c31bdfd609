"""Expert parallelism and moe data parallelism across pods: the port's
4-rank worlds against the reference's real sharded steps (an
``AxisType.Auto`` mesh of four forced host devices, in a subprocess),
olmoe-1b-7b and mixtral-8x7b smoke:

* ``(pod 2, data 1, model 2)`` under ``hierarchical`` (``shard_map``
  manual over ``pod``, GSPMD on ``model``), fp32 and bf16;
* ``(pod 2, data 2, model 1)`` under ``auto`` (the dispatch group the
  whole batch, over both pods' four ranks) and ``hierarchical`` (each
  pod's two data ranks' rows), olmoe in fp32.

Inside the reference's per-pod program each pod's rows are a dispatch
group of their own and its load-balancing loss is the pod's (ROADMAP
C-ref10), and so are the port's.  The setup and tolerances are
``tests/_train_tp_common.py``'s."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _train_tp_common as common                             # noqa: E402
from test_torch_train_moe_tp import COMBOS                    # noqa: E402

# layout -> (combos, cases)
RUNS = {"2x1x2": (COMBOS, ["hierarchical"]),
        "2x2x1": (COMBOS[:1], ["auto", "hierarchical"])}
PARAMS = [(layout, c[0], case) for layout, (combos, cases) in RUNS.items()
          for c in combos for case in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {layout: common.run_layout(
        tmp_path_factory.mktemp(f"train_moe_{layout}"), layout, *RUNS[layout])
        for layout in RUNS}


@pytest.mark.parametrize("layout,sub,case", PARAMS)
def test_port_step_matches_reference_sharded_step(runs, layout, sub, case):
    common.check_against_reference(runs[layout], sub, case)


@pytest.mark.parametrize("layout,sub,case", PARAMS)
def test_replicated_leaves_and_repeats_in_bits(runs, layout, sub, case):
    common.check_bits(runs[layout], sub, case)
