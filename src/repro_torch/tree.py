"""Nested-dict trees of tensors, walked in JAX's order.

The port's params, optimizer states and checkpoints are plain nested
dicts.  ``jax.tree_util`` flattens a dict in sorted key order, and the
reference's optimizers and checkpoint files follow that order, so every
walk here sorts keys too: the n-th leaf here is the n-th leaf there.

The walks are module-level functions: a nested function that calls
itself is a reference cycle, which would keep the leaves it collected
(a step's gradients, an optimizer's state) alive until the cyclic
garbage collector happens to run.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["flatten_with_paths", "leaves", "unflatten", "tree_map",
           "treedef_str"]

IsLeaf = Optional[Callable[[Any], bool]]


def _is_node(x, is_leaf: IsLeaf) -> bool:
    return isinstance(x, dict) and not (is_leaf is not None and is_leaf(x))


def _walk(node, prefix: str, is_leaf: IsLeaf, out: list) -> None:
    if not _is_node(node, is_leaf):
        out.append((prefix, node))
        return
    for k in sorted(node):
        _walk(node[k], f"{prefix}/{k}" if prefix else str(k), is_leaf, out)


def flatten_with_paths(tree, is_leaf: IsLeaf = None
                       ) -> List[Tuple[str, Any]]:
    """(``/``-joined key path, leaf) pairs, keys sorted at every level."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", is_leaf, out)
    return out


def leaves(tree, is_leaf: IsLeaf = None) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree, is_leaf)]


def _build(node, it, is_leaf: IsLeaf):
    if not _is_node(node, is_leaf):
        return next(it)
    return {k: _build(node[k], it, is_leaf) for k in sorted(node)}


def unflatten(like, new_leaves, is_leaf: IsLeaf = None):
    """A tree shaped as ``like`` whose leaves are ``new_leaves``, in the
    order ``leaves(like)`` gives."""
    it = iter(new_leaves)
    out = _build(like, it, is_leaf)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest, is_leaf: IsLeaf = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (which have ``tree``'s structure)."""
    flat = [leaves(t, is_leaf) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)], is_leaf)


def _fmt(node) -> str:
    if not isinstance(node, dict):
        return "*"
    return "{" + ", ".join(f"{k!r}: {_fmt(node[k])}"
                           for k in sorted(node)) + "}"


def treedef_str(tree: Dict[str, Any]) -> str:
    """The structure as ``jax.tree_util.tree_structure(tree)`` prints it
    for a tree of dicts: ``PyTreeDef({'a': *, 'b': {'c': *}})``."""
    return f"PyTreeDef({_fmt(tree)})"
