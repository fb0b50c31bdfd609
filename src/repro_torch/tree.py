"""Tree helpers over the port's parameter trees (what ``jax.tree`` does
for the reference).

A tree is nested dicts, lists and tuples (a ``NamedTuple`` keeps its
type) with tensors (or any other objects) at the leaves.  The port keeps
a stacked reference leaf as a list of per-layer tensors
(``repro_torch.bridge``), so ``leaf_groups`` names the leaves as the
reference does and in its flatten order: dict keys sorted, every list
of like subtrees folded into one group per leaf path, its tensors in
layer order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the trees of like structure
    in ``rest``; returns a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``tree_map``'s order (dicts in insertion order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def leaf_groups(tree, prefix: str = ""
                ) -> Iterator[Tuple[str, List[Any], Tuple[int, ...]]]:
    """``(name, leaves, lead)`` per leaf of the reference's stacked tree,
    in its flatten order: ``name`` is the reference's leaf path joined by
    "/", ``leaves`` the port's tensors that stack into it, and ``lead``
    the stacked leading axes they fill (``()`` for a leaf kept whole,
    ``(L,)`` for a list of layers, outer lists first)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_groups(tree[k], f"{prefix}/{k}" if prefix else k)
    elif _is_namedtuple(tree):
        for k, v in zip(tree._fields, tree):
            yield from leaf_groups(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        groups: Dict[str, Tuple[List[Any], Tuple[int, ...]]] = {}
        for t in tree:
            for name, leaves, lead in leaf_groups(t, prefix):
                groups.setdefault(name, ([], (len(tree),) + lead))[0].extend(
                    leaves)
        for name, (leaves, lead) in groups.items():
            yield name, leaves, lead
    else:
        yield prefix, [tree], ()


def rebuild(template, supply: Dict[str, Iterator[Any]], prefix: str = ""):
    """A tree shaped as ``template`` whose leaves are drawn in order from
    ``supply[name]``, ``name`` the leaf's ``leaf_groups`` name: the
    inverse of ``leaf_groups``."""
    if isinstance(template, dict):
        return {k: rebuild(v, supply, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            rebuild(v, supply, f"{prefix}/{k}" if prefix else k)
            for k, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(rebuild(t, supply, prefix) for t in template)
    return next(supply[prefix])
