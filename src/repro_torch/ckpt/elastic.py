"""Elastic re-planning (port of ``repro.ckpt.elastic``): restore a
checkpoint onto a different world, and resize plans.

ScalePool's composable disaggregation means the compute pool can grow or
shrink independently of storage; a job restarted on 384 chips must
consume a checkpoint written on 512.  The manifest stores global shapes
and shard slices, so re-assembly is layout-agnostic: ``replan`` rebuilds
each full leaf from its shard files and re-slices it for the new grid's
rules, as the reference does, whether the checkpoint was written by the
reference on a sharded mesh, by the port on any layout, or whole.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.ckpt import checkpoint as C
from repro_torch.sharding import tp
from repro_torch.sharding.partition import Rules


def replan(ckpt_dir, target_tree, new_mesh=None,
           rules: Optional[Rules] = None, axes_tree=None
           ) -> Tuple[Any, Dict]:
    """Restore ``ckpt_dir`` (written on any world) for ``new_mesh``: the
    tree of ``target_tree``'s structure on its leaves' devices and
    dtypes, each leaf the restoring rank's block by ``rules`` and
    ``axes_tree`` (the tree's logical axes: ``Model.param_axes()``,
    ``AdamW.state_axes``), and ``{"step": ..., **extra}``.  Rules that
    shard nothing on ``new_mesh`` restore whole leaves."""
    if tp.make_plan(new_mesh, rules) is not None and axes_tree is None:
        raise ValueError("rules that shard the parameters need the tree's "
                         "logical axes (axes_tree) to re-slice it")
    return C.restore(ckpt_dir, target_tree, mesh=new_mesh, rules=rules,
                     axes=axes_tree)


def resize_plan(old_devices: int, new_devices: int, *,
                model_parallel: int = 16) -> Dict[str, int]:
    """Derive a (pods, data, model) decomposition for an elastic resize.

    Keeps model parallelism fixed (sharding layouts stay valid) and
    absorbs the change in the data-parallel/pod dimensions — the paper's
    composability axis.  Raises if the new size can't host the model."""
    if new_devices % model_parallel:
        raise ValueError(f"{new_devices} devices cannot host "
                         f"{model_parallel}-way model parallelism")
    data_total = new_devices // model_parallel
    pods = max(1, data_total // 16)
    while data_total % pods:
        pods -= 1
    return {"pods": pods, "data": data_total // pods, "model": model_parallel}
