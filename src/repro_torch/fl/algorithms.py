"""Baseline local-update rules the paper compares against (§5), as in
``src/repro/fl/algorithms.py``: the per-client math behind
``strategy("fedprox", mu=...)`` and ``strategy("scaffold")`` of
:mod:`repro_torch.fl.api`.

FedAvg / FedAsync / Per-FedAvg / pFedMe are presets of Algorithm 2's
Options A/B/C; FedProx and SCAFFOLD (Option I) need local steps of their
own, with the accumulated-delta structure of :mod:`repro_torch.core.client`:
the delta accumulates in f32 across the Q steps.  The reference's
``lax.scan`` is a Python loop here, and both functions run unchanged under
``torch.func.vmap`` over a cohort, SCAFFOLD's control variates riding the
cohort axis.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import grad

from repro_torch.core.client import _current_w
from repro_torch.core.maml import tree_norm
from repro_torch.core.types import PersAFLConfig
from repro_torch.tree import tree_leaves, tree_map

Loss = Callable


def _zeros_f32(params):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


def _local_sgd(pcfg: PersAFLConfig, loss_fn: Loss, params, batches,
               correct: Callable) -> Tuple:
    """Q steps of Δ ← Δ + η·correct(∇f(w₀ − Δ), Δ) over ``batches`` (leading
    dim Q); returns Δ and the per-step gradient norms' mean."""
    delta = _zeros_f32(params)
    gnorms = []
    for q in range(tree_leaves(batches)[0].shape[0]):
        batch_q = tree_map(lambda x: x[q], batches)
        g = correct(grad(loss_fn)(_current_w(params, delta), batch_q), delta)
        delta = tree_map(lambda d, gg: d + pcfg.eta * gg.float(), delta, g)
        gnorms.append(tree_norm(g))
    return delta, torch.stack(gnorms).mean()


def fedprox_update(pcfg: PersAFLConfig, loss_fn: Loss, params, batches,
                   mu: float = 0.1) -> Tuple:
    """FedProx [42]: local SGD on f_i(w) + μ/2 ‖w − w^t‖²."""
    # prox term: ∇ μ/2‖w − w0‖² = μ(w − w0) = −μ·Δ, in the gradient's dtype
    delta, gmean = _local_sgd(
        pcfg, loss_fn, params, batches,
        lambda g, delta: tree_map(lambda gg, d: gg + (-mu * d).to(gg.dtype),
                                  g, delta))
    return delta, {"grad_norm_mean": gmean, "delta_norm": tree_norm(delta)}


def scaffold_update(pcfg: PersAFLConfig, loss_fn: Loss, params, batches,
                    c_global, c_i) -> Tuple:
    """SCAFFOLD [34] (Option I) local update.

    w ← w − η (g − c_i + c);   c_i⁺ = ∇f_i(w^t) (a fresh pass at the server
    model on the first batch, the paper's more stable Option I);
    Δc = c_i⁺ − c_i.  Returns (delta, new_c_i, metrics).
    """
    delta, gmean = _local_sgd(
        pcfg, loss_fn, params, batches,
        lambda g, _: tree_map(lambda gg, ci, cg: gg + (cg - ci).to(gg.dtype),
                              g, c_i, c_global))
    first_batch = tree_map(lambda x: x[0], batches)
    c_new = tree_map(lambda g: g.float(),
                     grad(loss_fn)(params, first_batch))
    return delta, c_new, {"grad_norm_mean": gmean,
                          "delta_norm": tree_norm(delta)}
