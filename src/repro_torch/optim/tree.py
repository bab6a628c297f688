"""The pytree operations the optimizers need, on nested dicts, lists and
tuples of tensors, in JAX's leaf order (a dict's keys sorted), so that
leaf-order sums (the global gradient norm) add in the JAX package's
order; and the run length of their fp32 temporaries."""
from __future__ import annotations

from typing import Any, Callable, List

#: elements an optimizer's fp32 temporary spans at most: a larger leaf is
#: worked on in runs (an expert leaf of arctic-480b is 17.9 GB in fp32)
SLICE_ELEMENTS = 1 << 26


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure over ``leaves`` (in JAX's order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            vals = [build(v) for v in t]
            if isinstance(t, list):
                return vals
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of ``tree``."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def clear_tree(tree: Any) -> None:
    """Empty every dict and list of ``tree`` in place, so that the caller's
    containers stop holding its leaves (an optimizer's ``donate``)."""
    if isinstance(tree, dict):
        for v in tree.values():
            clear_tree(v)
        tree.clear()
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            clear_tree(v)
        if isinstance(tree, list):
            tree.clear()
