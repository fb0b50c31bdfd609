"""Logical-axis sharding: named activation/parameter axes -> mesh axes
(port of ``repro.sharding.partition``).

Model code of the reference annotates tensors with *logical* axis names
("batch", "embed", "ff", "heads", ...).  A per-(arch, mesh) rule table
maps logical names to mesh axes, so the model code stays mesh-agnostic
(the ScalePool composability requirement: any cluster shape, same model
code).

The port has no GSPMD, so ``Rules.spec`` returns a plain tuple, one
entry per dimension (``None``, a mesh axis, or a tuple of two or more
mesh axes): the contents of the reference's ``PartitionSpec``.  The
data-parallel training step reads the ``batch`` entry to take each
rank's rows (``repro_torch.runtime.train``).  The reference's ``constrain``,
``logical_to_sharding`` and ``tree_shardings`` place tensors on a mesh
for GSPMD; the port places nothing until the tensor-parallel / FSDP
slice, which will read ``spec`` for the ``model`` axis and the
parameters' ``embed`` axis.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


class Rules:
    """Mapping from logical axis name -> mesh axis (or tuple, or None)."""

    def __init__(self, table: Dict[str, MeshAxes]):
        self.table = dict(table)

    def spec(self, *logical_axes: Optional[str]) -> Spec:
        out = []
        used: set = set()
        for name in logical_axes:
            if name is None:
                out.append(None)
                continue
            axes = self.table.get(name)
            # a mesh axis may appear at most once in a spec
            if axes is None:
                out.append(None)
            elif isinstance(axes, str):
                if axes in used:
                    out.append(None)
                else:
                    used.add(axes)
                    out.append(axes)
            else:
                free = tuple(a for a in axes if a not in used)
                used.update(free)
                # one free axis is named bare, as PartitionSpec names it
                out.append(free[0] if len(free) == 1 else (free or None))
        return tuple(out)

    def override(self, **kw: MeshAxes) -> "Rules":
        t = dict(self.table)
        t.update(kw)
        return Rules(t)

    def strip_axis(self, axis: str) -> "Rules":
        """Remove one mesh axis from every rule (the reference uses it
        inside shard_map bodies where that axis is manual)."""
        t: Dict[str, MeshAxes] = {}
        for k, v in self.table.items():
            if v is None or v == axis:
                t[k] = None if v == axis else v
            elif isinstance(v, tuple):
                kept = tuple(a for a in v if a != axis)
                t[k] = kept if kept else None
            else:
                t[k] = v
        return Rules(t)


class _Ctx(threading.local):
    def __init__(self):
        self.rules: Optional[Rules] = None
        self.mesh = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules], mesh=None):
    prev = (_CTX.rules, _CTX.mesh)
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = prev


def current_rules() -> Optional[Rules]:
    return _CTX.rules
