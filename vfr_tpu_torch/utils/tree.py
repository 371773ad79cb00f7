"""Nested-dict parameter trees: flatten in sorted-key order (the order of
``jax.tree.leaves`` on a dict pytree) and map over matching trees."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple


def flatten(tree, prefix: Tuple[str, ...] = ()) -> Tuple[List[tuple],
                                                         List]:
    """(paths, leaves) of a nested dict, sorted keys at every level."""
    if isinstance(tree, dict):
        paths, leaves = [], []
        for k in sorted(tree):
            p, l = flatten(tree[k], prefix + (k,))
            paths.extend(p)
            leaves.extend(l)
        return paths, leaves
    return [prefix], [tree]


def unflatten(paths: List[tuple], leaves: List) -> Dict:
    """Inverse of ``flatten``."""
    out: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same nesting)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
