"""Nested dicts of tensors as the port's pytrees (params, optimizer
state, checkpoints), walked in the order JAX walks the same dicts: keys
sorted at every level, leaves named by their key path
(``params/blocks/pos0/mixer/wq``), so the port's trees line up leaf for
leaf with the reference's."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple


def tree_map(fn: Callable, tree):
    return ({k: tree_map(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


def tree_flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in ``jax.tree.leaves`` order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [item for k in sorted(tree)
            for item in tree_flatten_with_paths(
                tree[k], f"{prefix}/{k}" if prefix else str(k))]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_unflatten(like, leaves: Iterable):
    """A tree shaped like ``like`` holding ``leaves``, given in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(tree):
        if not isinstance(tree, dict):
            return next(it)
        return {k: build(tree[k]) for k in sorted(tree)}
    return build(like)
