"""Parameter and optimizer-state trees: nested dicts, lists and
NamedTuples of tensors, walked in the JAX package's order.

``jax.tree_util`` flattens a dict in sorted key order, a list or tuple in
index order and a NamedTuple in field order, and skips ``None``; the
port's train step and checkpoints walk trees the same way, and name a
leaf by the JAX checkpoint's path string (``checkpoint/manager.py:
_path_str``): dict keys, list indices and NamedTuple field names joined
by ``/``, for example ``opt/master/runs/0/attn/wq``.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path string, leaf)] in the JAX flattening order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out += leaves_with_path(child, f"{prefix}/{name}" if prefix else name)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(template, new_leaves) -> Any:
    """The structure of ``template`` with its leaves replaced, in order,
    by ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}          # keep the caller's order
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        return type(t)(build(v) for v in t)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), in one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
