"""Trees of tensors: nested dicts, lists, tuples and named tuples (the
parameter tree, an optimizer state, a checkpointed state), walked in one
fixed order (dicts by their keys' order, sequences by index)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_leaves(tree) -> List[Any]:
    """The leaves, in the tree's order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves at the same place in rest)`` over every leaf of
    ``tree``; the same structure out.  The other trees must have the
    structure of the first."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree, prefix: Tuple[str, ...] = ()
               ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf, in the JAX package's checkpoint naming:
    a dict entry by its key, a sequence entry by its index, a named tuple's
    field as ``.field``; dict keys sorted, as JAX flattens them."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [pl for name, v in zip(tree._fields, tree)
                for pl in tree_paths(v, prefix + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (str(i),))]
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable, tree, prefix: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over every leaf, paths as :func:`tree_paths`
    names them; the same structure out."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, prefix + (f".{n}",))
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
