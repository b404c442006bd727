"""Nested dict/list/tuple trees of tensors, the port's stand-in for JAX
pytrees.  Dict leaves come in sorted-key order, as ``jax.tree.leaves`` gives
them, so reductions over leaves sum in the reference's order.  ``None`` is an
empty node, as in JAX: the pruned personal-subset trees of
:mod:`repro_torch.core.subset` keep ``None`` in the list slots they skip, and
every function here passes it through.  Named tuples (``QuantStack``,
``QuantTree``) are nodes too."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _rebuild(node, children):
    if hasattr(node, "_fields"):           # a named tuple
        return type(node)(*children)
    return type(node)(children)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("tree_map: trees differ in structure")
        return _rebuild(tree, [tree_map(fn, *xs) for xs in zip(tree, *rest)])
    return fn(tree, *rest)


def _collect(node, out: List[Any]) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _collect(node[k], out)
    elif isinstance(node, (list, tuple)):
        for x in node:
            _collect(x, out)
    else:
        out.append(node)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    _collect(tree, out)
    return out


def _fill(node, it: Iterator):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _fill(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return _rebuild(node, [_fill(x, it) for x in node])
    return next(it)


def tree_unflatten(template, leaves: List[Any]):
    """``template``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it: Iterator = iter(leaves)
    out = _fill(template, it)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten: more leaves than the template has")
    return out
