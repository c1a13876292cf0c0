"""Nested-container trees of tensors: the port's stand-in for JAX pytrees.

The port keeps parameters, optimizer state and checkpoints as plain
containers: dicts (leaves in sorted key order, as ``jax.tree`` orders
them), tuples, lists and NamedTuples (in field order); ``None`` holds no
leaf. Everything else is a leaf. Folds over a tree (the global norm, the
checkpoint's leaf list) therefore visit leaves in the reference's order,
and ``leaves_with_paths`` spells a leaf's path as the reference's
checkpoint manager does (``jax.tree_util`` key entries joined by "/"), so
that a checkpoint written by the JAX package names its leaves as the
port does.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any):
    """``[(path entry, child)]`` of a container, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    if node is None:
        return []
    return None


def leaves_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in the reference's order; a path is the entries
    from the root joined by "/" (``['opt']/.m/['embed']/['table']``)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            out.append(("/".join(prefix), node))
            return
        for entry, child in kids:
            walk(child, prefix + [entry])

    walk(tree, [])
    return out


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (which share its structure); returns the same structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if tree is None:
        return None
    items = [tree_map(fn, x, *(r[i] for r in rest))
             for i, x in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)


def unflatten(tree: Any, new_leaves: List[Any]) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` (given in the
    reference's leaf order)."""
    it = iter(new_leaves)

    def walk(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if node is None:
            return None
        items = [walk(child) for _, child in kids]
        if _is_namedtuple(node):
            return type(node)(*items)
        return type(node)(items)

    out = walk(tree)
    if next(it, it) is not it:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out
