"""Nested containers of tensors ("trees"): the port's stand-in for
``jax.tree``, which the reference's optimizer, train step and checkpoints
walk.

A tree is a ``dict`` (its keys visited in sorted order, as JAX visits
them), a ``list``, a ``tuple`` or a ``NamedTuple`` of trees; anything
else is a leaf.  ``None`` is a leaf here (JAX makes it an empty node), so
an absent part of a state keeps its slot and checkpoints can mark it.
:func:`structure` names the containers, their keys and the leaf slots;
checkpoints save it and compare it on restore.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

# a spec is ("leaf",), ("dict", keys, children), ("list", children),
# ("tuple", children) or ("namedtuple", cls, children)
Spec = Tuple[Any, ...]
LEAF: Spec = ("leaf",)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def flatten(tree: Any) -> Tuple[List[Any], Spec]:
    """``tree`` → (its leaves in visiting order, its spec)."""
    leaves: List[Any] = []
    spec = _walk(tree, leaves)
    return leaves, spec


# _walk and _build are module functions, not closures of flatten and
# unflatten: a closure that calls itself is a reference cycle, which would
# keep the leaves (a step's gradients, say) alive until the next garbage
# collection instead of freeing them when the caller drops them
def _walk(node: Any, leaves: List[Any]) -> Spec:
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys),
                tuple(_walk(node[k], leaves) for k in keys))
    if _is_namedtuple(node):
        return ("namedtuple", type(node),
                tuple(_walk(c, leaves) for c in node))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, tuple(_walk(c, leaves) for c in node))
    leaves.append(node)
    return LEAF


def unflatten(spec: Spec, leaves: List[Any]) -> Any:
    """The inverse of :func:`flatten`."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, spec) is not spec:
        raise ValueError("more leaves than the spec has slots")
    return out


def _build(s: Spec, it) -> Any:
    kind = s[0]
    if kind == "leaf":
        return next(it)
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(s[1], s[2])}
    if kind == "namedtuple":
        return s[1](*(_build(c, it) for c in s[2]))
    children = [_build(c, it) for c in s[1]]
    return children if kind == "list" else tuple(children)


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), in a tree of ``tree``'s shape."""
    flat, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("tree_map over trees of different structure")
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])


def structure(tree: Any) -> str:
    """A string naming ``tree``'s containers, keys and leaf slots (``*``
    for a leaf, ``None`` for a ``None`` leaf)."""
    def show(node: Any) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {show(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return type(node).__name__ + "(" + ", ".join(
                f"{f}={show(c)}" for f, c in zip(node._fields, node)) + ")"
        if isinstance(node, list):
            return "[" + ", ".join(show(c) for c in node) + "]"
        if isinstance(node, tuple):
            return "(" + ", ".join(show(c) for c in node) + ",)"
        return "None" if node is None else "*"
    return show(tree)
