"""Elastic resize plans (port of ``repro.ckpt.elastic.resize_plan``).

ScalePool's composable disaggregation means the compute pool can grow or
shrink independently of storage; a job restarted on 384 chips must
consume a checkpoint written on 512.  ``resize_plan`` picks the new
(pods, data, model) decomposition a lease resize hands the runtime.
Restoring a checkpoint onto the new layout (the reference's ``replan``)
comes with the ``torch.distributed`` slice.
"""

from __future__ import annotations

from typing import Dict


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
