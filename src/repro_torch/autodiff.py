"""The gradient of a scalar function of a params tree, for the port's
training rules.

``torch.func.grad`` runs its backward with ``create_graph=True`` (so that an
enclosing transform can differentiate it again), which keeps every
backward intermediate alive until the gradient returns: the gradients of
every layer's activations and the plain backward's recomputed attention
logits and SSD chunk tensors.  At mamba2-130m's (8, 512) one gradient
evaluation peaked at 37.5 GB on the card that way, and granite-moe-1b-a400m's
Option C round did not fit in 80 GB.  :func:`grad` takes the plain autograd
gradient (no graph of the backward) when no ``torch.func`` transform
encloses the call, and ``torch.func.grad`` inside one (the cohort engine's
``vmap``, Option B's ``jvp`` of ``grad``), where it must compose.  Both
run the same backward.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad as func_grad

from repro_torch.tree import tree_leaves, tree_unflatten


def _in_transform() -> bool:
    return torch._C._functorch.peek_interpreter_stack() is not None


def grad(fn: Callable) -> Callable:
    """``grad(fn)(params, *args)``: the gradient of the scalar
    ``fn(params, *args)`` with respect to the tree ``params``, a tree of
    its structure."""
    transformed = func_grad(fn)

    def g(params, *args):
        if _in_transform():
            return transformed(params, *args)
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        with torch.enable_grad():
            out = fn(tree_unflatten(params, leaves), *args)
            grads = torch.autograd.grad(out, leaves, allow_unused=True)
        return tree_unflatten(params, [
            torch.zeros_like(x) if gx is None else gx
            for gx, x in zip(grads, leaves)])

    return g
