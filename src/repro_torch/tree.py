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

__all__ = ["flatten", "leaf_names", "tree_map", "unflatten"]


def _walk(tree: Any, path: str, out: list[tuple[str, Any]]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{path}[{k!r}]", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _walk(v, f"{path}[{i}]", out)
    else:
        out.append((path, tree))


def _with_paths(tree: Any) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def flatten(tree: Any) -> list[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in _with_paths(tree)]


def leaf_names(tree: Any) -> list[str]:
    """``jax.tree_util.keystr`` of every leaf, in :func:`flatten` order."""
    return [path for path, _ in _with_paths(tree)]


def unflatten(like: Any, leaves: list[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(node: Any) -> Any:
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


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise over trees of one structure."""
    others = [flatten(r) for r in rest]
    leaves = flatten(tree)
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves)])
