"""Pytrees of tensors with the JAX package's canonical leaf order.

JAX flattens a dict in sorted key order and tuples, lists and NamedTuples
in order; ``None`` holds no leaf.  Bucket layouts (``core/bucketing.py``)
are a function of that order, so the port flattens the same way
(``torch.utils._pytree`` keeps a dict's insertion order instead).

A treedef here is a hashable nested tuple, so layouts and plans can be
cached on it as the JAX package caches on ``PyTreeDef``.  The recursions
are module functions, not closures: a closure that calls itself is a
reference cycle, which would keep every leaf it saw alive until Python's
cycle collector ran (tens of GB of averaging buffers on the card).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch

_LEAF = "*"


class Spec(NamedTuple):
    """Shape and dtype of a leaf: the port's ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(node, leaves: list):
    """The treedef of ``node``; its leaves are appended to ``leaves``."""
    if node is None:
        return ("none",)
    if isinstance(node, Spec):
        leaves.append(node)
        return _LEAF
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_walk(node[k], leaves) for k in keys))
    if _is_namedtuple(node):
        return ("namedtuple", type(node), tuple(_walk(c, leaves)
                                                for c in node))
    if isinstance(node, (tuple, list)):
        return (type(node).__name__, tuple(_walk(c, leaves) for c in node))
    leaves.append(node)
    return _LEAF


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in JAX order, hashable treedef)."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(d, it):
    if d == _LEAF:
        return next(it)
    kind = d[0]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    if kind == "namedtuple":
        return d[1](*(_build(c, it) for c in d[2]))
    children = [_build(c, it) for c in d[1]]
    return tuple(children) if kind == "tuple" else children


def tree_unflatten(treedef, leaves):
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the treedef holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-structured ``rest``."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree_map: trees of different structure")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def struct(tree, drop: int = 0):
    """The tree's leaves as :class:`Spec`; ``drop`` leading dims removed
    (``drop=1`` turns a stacked ``(P, ...)`` tree into one replica's)."""
    return tree_map(lambda a: Spec(tuple(a.shape[drop:]), a.dtype), tree)
