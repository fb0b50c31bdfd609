"""Elastic re-planning (port of ``repro.ckpt.elastic``): restore a
checkpoint onto a different world, and resize plans.

ScalePool's composable disaggregation means the compute pool can grow or
shrink independently of storage; a job restarted on 384 chips must
consume a checkpoint written on 512.  The manifest stores global shapes
and shard slices, so re-assembly is layout-agnostic.  The port's
data-parallel state is whole on every rank, so a checkpoint is written
by rank 0 alone (``ckpt.checkpoint.save``, process 0) and ``replan``
reads every leaf whole onto the restoring rank's own device, whatever
the world that wrote it (4 ranks -> 2 -> 1).  The reference re-slices
each leaf for the new mesh's shardings; the port has none to slice for
until the tensor-parallel / FSDP slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.ckpt import checkpoint as C
from repro_torch.sharding.partition import Rules
from repro_torch.sharding.profiles import grid_refusal


def replan(ckpt_dir, target_tree, new_mesh=None,
           rules: Optional[Rules] = None, axes_tree=None
           ) -> Tuple[Any, Dict]:
    """Restore ``ckpt_dir`` (written on any world) for ``new_mesh``: the
    tree of ``target_tree``'s structure on its leaves' devices and
    dtypes, and ``{"step": ..., **extra}``.  ``rules`` that shard the
    parameters (``embed`` on a mesh axis) and a ``model`` axis over 1
    are refused, as the data-parallel step refuses them; ``axes_tree``
    (the reference's logical axes per leaf) places nothing yet."""
    del axes_tree
    if new_mesh is not None:
        why = grid_refusal(new_mesh, rules)
        if why is not None:
            raise ValueError(why)
    return C.restore(ckpt_dir, target_tree)


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
