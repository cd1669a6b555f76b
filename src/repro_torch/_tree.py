"""Nested dicts of tensors as trees: the port's form of the reference's
pytrees of parameters, optimizer moments and gradients."""

from __future__ import annotations

from typing import Any, Callable


def map_with_path(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """`fn(path, leaf, *leaves)` over every leaf of `tree` and the leaves at
    the same place in `rest`; `path` is the tuple of dict keys to the leaf.
    Returns a tree of `tree`'s structure."""
    if isinstance(tree, dict):
        return {
            k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
            for k, v in tree.items()
        }
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn(leaf, *leaves)` over every leaf, as `jax.tree.map`."""
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def leaves(tree: Any) -> list:
    """The leaves of `tree` in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]
