"""Trees of tensors: nested dicts, lists and tuples (the params' layout,
the optimizer's state, a pipeline stage's params), a leaf anything else.

Leaves are visited in the reference's ``tree_leaves`` order: dict keys
sorted, lists and tuples by index.  A leaf's path is its keys joined by
``/`` (the whole tree's, when the tree is a leaf, is ``""``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def _children(tree) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of a container in leaf order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over ``tree``'s leaves, each of
    ``rest`` a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for k, v in kids
            for x in leaves_with_paths(v, f"{prefix}/{k}" if prefix
                                       else str(k))]


def tree_from_paths(template, values: Dict[str, Any], prefix: str = ""):
    """``template``'s containers with each leaf ``values[path]`` (the
    paths of :func:`leaves_with_paths`)."""
    kids = _children(template)
    if kids is None:
        return values[prefix]
    built = {k: tree_from_paths(v, values, f"{prefix}/{k}" if prefix
                                else str(k)) for k, v in kids}
    if isinstance(template, dict):
        return {k: built[k] for k in template}
    return type(template)(built[i] for i in range(len(template)))
