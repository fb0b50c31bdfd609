"""Weight and cache bridge from the reference's trees to the port's.

The reference's parameters are ``model.init(PRNGKey)`` with leaves
converted to numpy (``np.asarray``).  Its layer stacks are unstacked into
lists, the layout the port's Python layer loops walk:

- ``"layers"`` (dense, moe and mamba2): ``(L, ...)`` leaves -> one
  dict per layer (the moe experts' ``(L, E, d, f)`` leaves -> ``(E, d,
  f)`` per layer, the fp32 router as it is);
- ``"enc_layers"``, ``"dec_layers"`` (encdec): likewise;
- ``"mamba_main"`` (hybrid): ``(n_groups, per, ...)`` leaves -> a list
  of groups, each a list of ``per`` layer dicts;
- ``"mamba_tail"`` (hybrid): ``(tail, ...)`` leaves -> one dict per layer;

every other subtree (``embedding``, ``final_norm``, the hybrid's one
``shared_attn`` block, the encdec's ``enc_norm`` and ``dec_norm``)
keeps its paths.  ``pool_from_reference``
converts a page pool or a cache leaf for leaf: the port keeps the
reference's stacked cache layouts (``{"k","v"}``; mamba2 ``{"conv",
"ssd"}``; hybrid also ``"conv_tail"``, ``"ssd_tail"``).

Only numpy goes in: this module never imports JAX.  bf16 arrays (numpy's
``bfloat16`` extension dtype) are carried over bit for bit.
``params_to_reference`` is the inverse, for trees without bf16 leaves
(numpy has no bfloat16 of its own): the port's per-layer lists stacked
back into the reference's ``(L, ...)`` numpy leaves.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# subtree -> number of stacked leading layer axes
STACKED = {"layers": 1, "mamba_main": 2, "mamba_tail": 1,
           "enc_layers": 1, "dec_layers": 1}


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


def _first_leaf(tree):
    for v in tree.values():
        leaf = _first_leaf(v) if isinstance(v, dict) else v
        if leaf is not None:
            return leaf
    return None


def _unstack(tree, depth: int):
    """Split the leading ``depth`` axes of every leaf into nested lists."""
    if depth == 0:
        return tree

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} \
            if isinstance(t, dict) else t[i].clone()

    n = _first_leaf(tree).shape[0]
    return [_unstack(take(tree, i), depth - 1) for i in range(n)]


def params_from_reference(tree: Mapping[str, Any],
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Reference parameter tree (any family) -> port parameters."""
    return {k: _unstack(_convert(v, device), STACKED.get(k, 0))
            for k, v in tree.items()}


def pool_from_reference(pool: Mapping[str, Any],
                        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Reference page pool or cache -> port tensors, same layout."""
    return {k: to_tensor(v, device) for k, v in pool.items()}


def _stack(items):
    """Like trees of tensors -> one tree of tensors stacked on a new
    leading axis."""
    if isinstance(items[0], dict):
        return {k: _stack([t[k] for t in items]) for k in items[0]}
    return torch.stack([t.detach() for t in items])


def _restack(tree, depth: int):
    if depth == 0:
        return tree
    return _stack([_restack(t, depth - 1) for t in tree])


def params_to_reference(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Port parameters (any family) -> the reference's tree of numpy
    leaves, the inverse of ``params_from_reference``."""
    def numpy(t):
        if t.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: upcast bf16 parameters "
                            "before converting them")
        return t.detach().cpu().numpy()

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        return numpy(tree)

    return {k: convert(_restack(v, STACKED.get(k, 0)))
            for k, v in params.items()}
