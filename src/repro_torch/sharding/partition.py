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
rank's rows (``repro_torch.runtime.train``).

Placement on a rank grid (``repro_torch.launch.mesh.RankGrid``): the
reference's ``logical_to_sharding`` and ``tree_shardings`` give a
``NamedSharding`` per leaf; here they give a ``Block`` per leaf, the
slice of each dimension one rank holds (a mesh axis of size 1 gives the
whole dimension).  ``shard_leaf`` cuts a full tensor to a rank's block,
``gather_leaf`` puts the blocks of the axes a spec names back together.
The reference's ``constrain`` pins GSPMD's choices for activations; the
port has no GSPMD to pin: its collectives inside the model are explicit
(``repro_torch.sharding.tp``), at the places GSPMD puts them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterator, Optional, Tuple, Union

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


def current_mesh():
    return _CTX.mesh


# ---------------------------------------------------------------------------
# placement on a rank grid
# ---------------------------------------------------------------------------

def is_axes_leaf(x) -> bool:
    """A logical-axes leaf is a plain tuple of axis names / None (possibly
    empty), NOT a NamedTuple (those are tree nodes, e.g. optimizer
    states)."""
    return (type(x) is tuple
            and all(e is None or isinstance(e, str) for e in x))


def _entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Block:
    """One rank's block of a leaf: per dimension the mesh axes that
    split it (those of size 1 dropped), and the rank's part ``(index,
    count)`` of it, row-major over those axes."""
    axes: Tuple[Tuple[str, ...], ...]
    parts: Tuple[Tuple[int, int], ...]

    @property
    def sharded_over(self) -> Tuple[str, ...]:
        """Every mesh axis that splits the leaf, in dimension order."""
        return tuple(a for axes in self.axes for a in axes)

    @property
    def whole(self) -> bool:
        return not self.sharded_over

    def slices(self, shape) -> Tuple[slice, ...]:
        """The block's slice of each dimension of a leaf of global
        ``shape``."""
        out = []
        for n, (i, k) in zip(shape, self.parts):
            if n % k:
                raise ValueError(f"dimension {n} does not split in {k} "
                                 f"(shape {tuple(shape)}, {self.axes})")
            out.append(slice(i * n // k, (i + 1) * n // k))
        return tuple(out)

    def index(self, shape):
        """The reference manifest's ``index`` of this block: per
        dimension ``[start, stop, None]``, ``[None, None, None]`` where
        the dimension is whole (as ``jax``'s shard indices)."""
        return [[None, None, None] if k == 1 else [s.start, s.stop, None]
                for s, (_, k) in zip(self.slices(shape), self.parts)]


def block_of(layout, coords: Dict[str, int], rules: Rules,
             logical_axes) -> Block:
    """The block of the rank at ``coords`` on ``layout`` (anything with
    ``axis_names`` and ``shape``) of a leaf with ``logical_axes``."""
    sizes = dict(zip(layout.axis_names, layout.shape))
    axes, parts = [], []
    for entry in rules.spec(*logical_axes):
        names = tuple(a for a in _entry_axes(entry) if sizes.get(a, 1) > 1)
        i, k = 0, 1
        for a in names:
            i, k = i * sizes[a] + coords[a], k * sizes[a]
        axes.append(names)
        parts.append((i, k))
    return Block(tuple(axes), tuple(parts))


def replica_zero(block: Block, coords: Dict[str, int]) -> bool:
    """Whether the rank at ``coords`` holds the first replica of its
    block (the reference's ``replica_id == 0``): index 0 on every axis
    that does not split the leaf."""
    split = set(block.sharded_over)
    return all(i == 0 for a, i in coords.items() if a not in split)


def logical_to_sharding(mesh, rules: Rules, logical_axes) -> Block:
    """This rank's ``Block`` of a leaf with ``logical_axes`` on the rank
    grid ``mesh``."""
    return block_of(mesh.layout, mesh.coords, rules, logical_axes)


def map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over the logical-axes leaves of
    ``axes_tree`` (dicts, lists and NamedTuples around ``is_axes_leaf``
    tuples) and the leaves of ``trees`` of the same structure."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(map_axes(fn, *vs)
                                 for vs in zip(axes_tree, *trees)))
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, *vs)
                               for vs in zip(axes_tree, *trees))
    raise TypeError(f"not a logical-axes tree: {axes_tree!r}")


def tree_shardings(mesh, rules: Rules, logical_tree):
    """A tree of this rank's ``Block`` per leaf of a logical-axes tree."""
    return map_axes(lambda axes: logical_to_sharding(mesh, rules, axes),
                    logical_tree)


def named_axes(axes_tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(name, axes)`` per leaf, ``name`` as ``repro_torch.tree.
    leaf_groups`` names the leaves of a tree of the same structure (a
    list's like subtrees folded into one name)."""
    if is_axes_leaf(axes_tree):
        yield prefix, axes_tree
    elif isinstance(axes_tree, dict):
        for k in sorted(axes_tree):
            yield from named_axes(axes_tree[k],
                                  f"{prefix}/{k}" if prefix else k)
    elif isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        for k, v in zip(axes_tree._fields, axes_tree):
            yield from named_axes(v, f"{prefix}/{k}" if prefix else k)
    else:
        seen = {}
        for t in axes_tree:
            for name, axes in named_axes(t, prefix):
                if seen.setdefault(name, axes) != axes:
                    raise ValueError(f"{name}: layers with other axes")
        yield from seen.items()


def shard_leaf(full, block: Block):
    """This rank's block of the full tensor ``full``, as a tensor of its
    own (the full one may then be freed)."""
    if block.whole:
        return full
    return full[block.slices(full.shape)].clone()


def gather_leaf(local, block: Block, mesh):
    """The full tensor from each rank's ``local`` block: one all-gather
    over each dimension's axes (``repro_torch.core.hierarchy``), the
    inverse of ``shard_leaf``."""
    from repro_torch.core import hierarchy
    out = local
    for dim, axes in enumerate(block.axes):
        if axes:
            out = hierarchy.all_gather_dim(out, mesh, axes, dim)
    return out
