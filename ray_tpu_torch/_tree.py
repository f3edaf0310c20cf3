"""Parameter trees: nested dicts, lists and tuples of tensors (the port's
counterpart of JAX pytrees).  Leaves come out in JAX's order (dict keys
sorted), so two trees of the same structure line up leaf by leaf whatever
order their dicts were built in."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of ``tree`` and ``rest``, in
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *rest)


def _children(node: Any):
    """(key, child) pairs of a tree node in JAX's flattening order, or None
    for a leaf: dict keys sorted, sequence indexes, named-tuple fields;
    None is a node with no children."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def tree_flatten_with_keys(tree: Any, is_leaf: Callable = None,
                           prefix: str = "") -> List[tuple]:
    """[(key, leaf)] in tree_leaves order, each key the "a/b/0" path JAX's
    checkpoints name a leaf by (``jax.tree_util`` key paths: dict keys,
    sequence indexes, named-tuple field names)."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [kl for k, v in kids
            for kl in tree_flatten_with_keys(
                v, is_leaf, f"{prefix}/{k}" if prefix else k)]


def tree_map_with_keys(fn: Callable, tree: Any, is_leaf: Callable = None,
                       prefix: str = "") -> Any:
    """``fn(key, leaf)`` over the leaves of ``tree``, in its structure
    (keys as ``tree_flatten_with_keys`` names them)."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return fn(prefix, tree)
    if tree is None:
        return None
    mapped = {k: tree_map_with_keys(fn, v, is_leaf,
                                    f"{prefix}/{k}" if prefix else k)
              for k, v in kids}
    if isinstance(tree, dict):
        return {k: mapped[str(k)] for k in tree}
    items = [mapped[k] for k, _ in kids]
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else type(tree)(items)
