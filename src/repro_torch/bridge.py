"""Weight and KV bridge from the reference's trees to the port's.

The reference's parameters are ``model.init(PRNGKey)`` with leaves
converted to numpy (``np.asarray``); its transformer layers are stacked
``(L, ...)`` leaves under ``"layers"``.  ``params_from_reference`` keeps
every path and unstacks the layer stack into one dict per layer, the
layout ``repro_torch.models.transformer`` walks.  ``pool_from_reference``
converts a ``{"k", "v"}`` page pool (or KV cache) leaf for leaf.

Only numpy goes in: this module never imports JAX.  bf16 arrays (numpy's
``bfloat16`` extension dtype) are carried over bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def to_tensor(arr, device: DeviceLike = None) -> torch.Tensor:
    """One numpy leaf -> torch tensor on ``device``, bits preserved."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(resolve_device(device))


def _convert(tree, device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _convert(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)


def params_from_reference(tree: Mapping[str, Any],
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Reference dense-transformer parameter tree -> port parameters."""
    out = {k: _convert(v, device) for k, v in tree.items() if k != "layers"}
    stacked = _convert(tree["layers"], device)

    def first_leaf(t):
        for v in t.values():
            leaf = first_leaf(v) if isinstance(v, dict) else v
            if leaf is not None:
                return leaf
        return None

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} \
            if isinstance(t, dict) else t[i].clone()

    n_layers = first_leaf(stacked).shape[0]
    out["layers"] = [take(stacked, i) for i in range(n_layers)]
    return out


def pool_from_reference(pool: Mapping[str, Any],
                        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Reference ``{"k","v"}`` pool or cache -> port tensors, same layout."""
    return {k: to_tensor(v, device) for k, v in pool.items()}
