"""Map / flatten / unflatten for nested dict, list and tuple trees.

Dicts flatten in **sorted-key order**, as ``jax.tree.leaves`` does: bucket
slots, the per-leaf loop order of the fused tail and so the summation
order of the Eq. 17 norms all follow the flatten order, so a port that
flattened in insertion order would get another bucket layout than the
reference.  Anything that is not a dict, list or tuple is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any
TreeDef = Any


def flatten(tree: Tree) -> Tuple[List[Any], TreeDef]:
    """(leaves in flatten order, a structure that `unflatten` rebuilds)."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


# The recursions are module-level functions, not closures: a nested
# function that calls itself is a reference cycle, and the cycle would
# keep the leaves it closes over (model-sized tensors) alive until
# Python's cyclic collector happens to run.
def _flatten(t: Tree, leaves: List[Any]) -> TreeDef:
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, tuple(keys), tuple(_flatten(t[k], leaves)
                                         for k in keys))
    if isinstance(t, (list, tuple)):
        return (type(t), None, tuple(_flatten(x, leaves) for x in t))
    leaves.append(t)
    return None


def unflatten(treedef: TreeDef, leaves) -> Tree:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def _unflatten(d: TreeDef, it) -> Tree:
    if d is None:
        return next(it)
    typ, keys, children = d
    if typ is dict:
        return {k: _unflatten(c, it) for k, c in zip(keys, children)}
    items = [_unflatten(c, it) for c in children]
    return typ(*items) if hasattr(typ, "_fields") else typ(items)


def leaves(tree: Tree) -> List[Any]:
    return flatten(tree)[0]


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001
    """``fn`` over corresponding leaves of trees with one structure."""
    ls, td = flatten(tree)
    others = [flatten(t) for t in rest]
    for _, otd in others:
        if otd != td:
            raise ValueError("tree.map: trees differ in structure")
    return unflatten(td, [fn(*xs) for xs in zip(ls, *(o[0] for o in others))])
