"""Partial-model personalization: the ``personal_subset`` param-tree spec, as
in ``src/repro/core/subset.py``.

The model splits into a shared backbone and a small per-user *personal
subset* (a head, the last blocks): only the subset is personalized per user,
so only the subset is banked per user.  A :class:`SubsetSpec` is a frozen
tuple of *path prefixes* in the checkpoint store's flat layout
(:mod:`repro_torch.checkpoint.store`): dict keys joined by ``/``, list and
tuple indices spelled ``#i``, e.g. ``("fc/#1",)`` for the last
fully-connected layer of the paper's CNN.  A prefix selects every leaf at or
below it.  Specs also build from a tree of bools (True leaves are personal).

Subset trees use the **pruned form**: dict keys with no selected leaf are
dropped and unselected list slots become ``None`` (an empty node, skipped by
:func:`repro_torch.tree.tree_map`), trailing ``None`` slots trimmed.  The
form is closed under the npz store, so bank rows, ring snapshots and
checkpoints share one structure.  Every helper is a structural walk.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves

_MISSING = object()


def leaf_paths(tree) -> Tuple[str, ...]:
    """Every leaf path of ``tree`` in the checkpoint store's flat spelling,
    sorted."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}#{i}/")
        elif node is not None:
            out.append(prefix[:-1])

    walk(tree, "")
    return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class SubsetSpec:
    """The personal subset of a params tree, as flat path prefixes.

    Hashable; equality is on the prefix tuple.  Leaf path ``p`` is personal
    iff some prefix ``q`` satisfies ``p == q`` or ``p.startswith(q + "/")``.
    """

    prefixes: Tuple[str, ...]

    @staticmethod
    def resolve(spec, tree=None) -> Optional["SubsetSpec"]:
        """Normalize any accepted spelling to a SubsetSpec (or None): None,
        a SubsetSpec, one comma-separated prefix string, an iterable of
        prefix strings, or a tree of bools.  With ``tree`` given, the spec
        is validated against it (:meth:`validate`)."""
        if spec is None:
            return None
        if isinstance(spec, SubsetSpec):
            out = spec
        elif isinstance(spec, str):
            out = SubsetSpec(tuple(p for p in spec.split(",") if p))
        elif isinstance(spec, (list, tuple)) and spec \
                and all(isinstance(p, str) for p in spec):
            out = SubsetSpec(tuple(spec))
        elif isinstance(spec, (dict, list, tuple)):
            paths = []

            def walk(node, prefix):
                if isinstance(node, dict):
                    for k in node:
                        walk(node[k], f"{prefix}{k}/")
                elif isinstance(node, (list, tuple)):
                    for i, v in enumerate(node):
                        walk(v, f"{prefix}#{i}/")
                elif node:
                    paths.append(prefix[:-1])

            walk(spec, "")
            out = SubsetSpec(tuple(sorted(paths)))
        elif isinstance(spec, Iterable):
            out = SubsetSpec(tuple(str(p) for p in spec))
        else:
            raise TypeError(f"cannot build a SubsetSpec from {type(spec)}")
        if not isinstance(out.prefixes, tuple) \
                or not all(isinstance(p, str) for p in out.prefixes):
            raise TypeError("SubsetSpec prefixes must be a tuple of paths")
        if not out.prefixes:
            raise ValueError("personal_subset selects no leaves")
        if tree is not None:
            out.validate(tree)
        return out

    @staticmethod
    def from_descriptor(paths) -> "SubsetSpec":
        """Rebuild from a checkpoint descriptor (a list of paths)."""
        return SubsetSpec(tuple(str(p) for p in paths))

    def _match(self, path: str) -> bool:
        return any(path == q or path.startswith(q + "/")
                   for q in self.prefixes)

    def validate(self, tree) -> Tuple[str, ...]:
        """Personal leaf paths of ``tree``; raises if a prefix matches
        nothing (a typo'd subset fails loudly)."""
        paths = leaf_paths(tree)
        for q in self.prefixes:
            if not any(p == q or p.startswith(q + "/") for p in paths):
                raise ValueError(
                    f"personal_subset prefix {q!r} matches no param leaf; "
                    f"leaves are {list(paths)[:8]}...")
        return tuple(p for p in paths if self._match(p))

    def descriptor(self, tree=None) -> list:
        """JSON-able descriptor: the resolved leaf paths of ``tree`` when
        given, the raw prefixes otherwise."""
        return list(self.validate(tree)) if tree is not None \
            else list(self.prefixes)

    def extract(self, tree):
        """``tree`` restricted to the personal subset, in pruned form."""

        def walk(node, prefix):
            if isinstance(node, dict):
                out = {}
                for k in node:
                    sub = walk(node[k], f"{prefix}{k}/")
                    if sub is not _MISSING:
                        out[k] = sub
                return out if out else _MISSING
            if isinstance(node, (list, tuple)):
                subs = [walk(v, f"{prefix}#{i}/")
                        for i, v in enumerate(node)]
                if all(s is _MISSING for s in subs):
                    return _MISSING
                last = max(i for i, s in enumerate(subs)
                           if s is not _MISSING)
                return [None if s is _MISSING else s
                        for s in subs[:last + 1]]
            if node is None:
                return _MISSING
            return node if self._match(prefix[:-1]) else _MISSING

        sub = walk(tree, "")
        return {} if sub is _MISSING else sub

    def mask(self, tree):
        """``tree``-structured tree of Python bools (True = personal)."""

        def walk(node, prefix):
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                out = [walk(v, f"{prefix}#{i}/") for i, v in enumerate(node)]
                return type(node)(out) if isinstance(node, tuple) else out
            if node is None:
                return None
            return self._match(prefix[:-1])

        return walk(tree, "")


def merge_subset(full, sub):
    """``full`` with every leaf present in ``sub`` replaced by ``sub``'s;
    the other leaves are ``full``'s own objects.  Tolerates every pruned
    spelling of ``sub`` (missing keys, gap lists, None)."""
    if sub is None:
        return full
    if isinstance(full, dict):
        get = sub.get if isinstance(sub, dict) else (lambda k: None)
        return {k: merge_subset(v, get(k)) for k, v in full.items()}
    if isinstance(full, (list, tuple)):
        n = len(sub) if isinstance(sub, (list, tuple)) else 0
        out = [merge_subset(v, sub[i] if i < n else None)
               for i, v in enumerate(full)]
        return type(full)(out) if isinstance(full, tuple) else out
    return sub


def subset_like(full, sub):
    """``full``'s leaves re-arranged into ``sub``'s pruned structure: the
    params-side operand of a subset-shaped stacked apply."""
    if sub is None:
        return None
    if isinstance(sub, dict):
        return {k: subset_like(full[k], v) for k, v in sub.items()}
    if isinstance(sub, (list, tuple)):
        return [subset_like(full[i], v) for i, v in enumerate(sub)]
    return full


def _nbytes(x, skip_axis0: bool) -> int:
    shape = tuple(x.shape)[1:] if skip_axis0 else tuple(x.shape)
    size = x.element_size() if isinstance(x, torch.Tensor) \
        else np.dtype(x.dtype).itemsize
    return int(np.prod(shape, dtype=np.int64)) * size


def tree_nbytes(tree) -> int:
    """Total leaf bytes of a tree (tensors or numpy arrays)."""
    return sum(_nbytes(x, False) for x in tree_leaves(tree))


def row_nbytes(stacked_tree) -> int:
    """Bytes of ONE row of a stacked ``[capacity, ...]`` bank buffer, the
    per-user unit of the ``ring_bytes_per_user`` stat."""
    return sum(_nbytes(x, True) for x in tree_leaves(stacked_tree))
