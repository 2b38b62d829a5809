"""Nested dict / tuple trees of tensors, flattened in the JAX package's order.

The trainer's state is the reference's pytree layout: dicts, the
``layers`` tuple, and tensors at the leaves.  ``jax.tree.leaves`` visits
dict keys in sorted order and sequences in index order; :func:`flatten`
does the same, so the port's state flattens to the same leaves in the same
order, and :func:`leaf_names` gives the same ``jax.tree_util.keystr``
names (``"['opt']['m']['layers'][0]['attn']['w_q']"``).  The checkpoint
files of both packages index leaves by that order, which is what lets a
checkpoint written by one restore in the other.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten", "is_axes", "leaf_names", "tree_map", "unflatten"]

Leaf = Callable[[Any], bool] | None


def is_axes(node: Any) -> bool:
    """A logical-axes leaf: a non-empty tuple of axis names or None (the
    reference's ``is_leaf`` for axes trees)."""
    return isinstance(node, tuple) and len(node) > 0 and all(
        isinstance(e, (str, type(None))) for e in node)


def _walk(tree: Any, path: str, out: list[tuple[str, Any]],
          is_leaf: Leaf) -> None:
    if is_leaf is not None and is_leaf(tree):
        out.append((path, tree))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{path}[{k!r}]", out, is_leaf)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _walk(v, f"{path}[{i}]", out, is_leaf)
    else:
        out.append((path, tree))


def _with_paths(tree: Any, is_leaf: Leaf = None) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    _walk(tree, "", out, is_leaf)
    return out


def flatten(tree: Any, is_leaf: Leaf = None) -> list[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order (``is_leaf``
    stops the walk at the nodes it accepts, as in JAX)."""
    return [leaf for _, leaf in _with_paths(tree, is_leaf)]


def leaf_names(tree: Any, is_leaf: Leaf = None) -> list[str]:
    """``jax.tree_util.keystr`` of every leaf, in :func:`flatten` order."""
    return [path for path, _ in _with_paths(tree, is_leaf)]


def unflatten(like: Any, leaves: list[Any], is_leaf: Leaf = None) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}      # keep the key order
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Leaf = None) -> Any:
    """``fn`` applied leafwise over trees of one structure (``is_leaf``
    applies to ``tree``; the ``rest`` align with its leaves)."""
    others = [flatten(r) for r in rest]
    leaves = flatten(tree, is_leaf)
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees do not align leaf for leaf")
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves)], is_leaf)
