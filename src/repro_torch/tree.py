"""Nested dict / tuple / list trees: the port's stand-in for jax pytrees.

Parameter trees, stored trees and their leaves' paths all go through these
functions. A NamedTuple is a leaf, not a node.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Tuple


def tree_map(fn: Callable, tree, is_leaf: Optional[Callable] = None):
    """Apply ``fn`` to every leaf of a nested dict/tuple/list tree."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree, is_leaf)


def tree_map_with_path(fn: Callable, tree, is_leaf: Optional[Callable] = None,
                       path: Tuple = ()):
    """Apply ``fn(path, leaf)`` to every leaf; a path is the tuple of dict
    keys / indices from the root."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, is_leaf, path + (k,))
                for k, v in tree.items()}
    if type(tree) in (tuple, list):
        return type(tree)(tree_map_with_path(fn, v, is_leaf, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_path(tree, is_leaf: Optional[Callable] = None,
                          path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """Yields (path, leaf); a path is the tuple of dict keys / indices."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, is_leaf, path + (k,))
    elif type(tree) in (tuple, list):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, is_leaf, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves in path order (the order every function here walks)."""
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def tree_map_multi(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest at the same path)`` over trees of one
    structure (``jax.tree.map`` over several trees); a path of ``tree``
    missing in another raises ``KeyError``."""
    others = [dict(tree_leaves_with_path(r)) for r in rest]
    return tree_map_with_path(
        lambda path, leaf: fn(leaf, *(o[path] for o in others)), tree)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in path order."""
    leaves = list(leaves)
    n = len(tree_leaves(like))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a structure of {n}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_structure(tree) -> str:
    """The structure as a string, every leaf written ``*``: what a
    checkpoint records where the reference writes ``str(treedef)``."""
    return str(tree_map(lambda _: "*", tree))
