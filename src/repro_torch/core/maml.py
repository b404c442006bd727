"""Option B — MAML personalized gradient estimators (paper Eq. 5 & 9), as in
``src/repro/core/maml.py``.

∇F_i(w) = [I − α ∇²f_i(w; D″)] ∇f_i(w − α ∇f_i(w; D′); D)

Three estimators:
  * ``full`` — exact Hessian-vector product, forward-over-reverse
    (``torch.func.jvp`` of ``torch.func.grad``), as the reference's
    ``jax.jvp`` of ``jax.grad``.
  * ``fo``   — FO-MAML: drop the Hessian term.
  * ``hf``   — HF-MAML (paper Eq. D1): central finite difference
    ∇²f(w)u ≈ [∇f(w+δu) − ∇f(w−δu)] / (2δ), direction-normalised.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import jvp

from repro_torch.autodiff import grad
from repro_torch.tree import tree_leaves, tree_map

Loss = Callable  # loss_fn(params, batch) -> scalar tensor


def _axpy(a: float, x, y):
    """y + a*x over trees (computed in the params' dtype)."""
    return tree_map(lambda xx, yy: yy + a * xx, x, y)


def tree_dot(x, y) -> torch.Tensor:
    return sum((a.float() * b.float()).sum()
               for a, b in zip(tree_leaves(x), tree_leaves(y)))


def tree_norm(x) -> torch.Tensor:
    return torch.sqrt(tree_dot(x, x))


def maml_grad(loss_fn: Loss, params, batch, batch_prime, batch_dprime,
              alpha: float, mode: str = "full", hf_delta: float = 1e-2):
    """Stochastic MAML gradient (Eq. 9). Returns a tree like ``params``."""
    g_inner = grad(loss_fn)(params, batch_prime)
    adapted = _axpy(-alpha, g_inner, params)
    g_outer = grad(loss_fn)(adapted, batch)
    if mode == "fo" or alpha == 0.0:
        return g_outer
    if mode == "full":
        # HVP at w on batch D'': ∇²f(w; D'') @ g_outer
        hvp = jvp(lambda p: grad(loss_fn)(p, batch_dprime),
                  (params,), (g_outer,))[1]
        return _axpy(-alpha, hvp, g_outer)
    if mode == "hf":
        # normalize the direction for numerical stability, rescale after
        nrm = tree_norm(g_outer)
        safe = torch.clamp(nrm, min=1e-12)
        u = tree_map(lambda g: (g / safe).to(g.dtype), g_outer)
        gp = grad(loss_fn)(_axpy(hf_delta, u, params), batch_dprime)
        gm = grad(loss_fn)(_axpy(-hf_delta, u, params), batch_dprime)
        fd = tree_map(
            lambda a, b: ((a - b) * (nrm / (2.0 * hf_delta))).to(a.dtype),
            gp, gm)
        return _axpy(-alpha, fd, g_outer)
    raise ValueError(f"unknown maml mode {mode!r}")


def personalize_maml(loss_fn: Loss, params, batch, alpha: float):
    """Client-side fine-tuning: one SGD step (the paper's evaluation
    budget)."""
    g = grad(loss_fn)(params, batch)
    return _axpy(-alpha, g, params)
