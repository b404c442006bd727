"""Algorithm 2 — client local update (Q steps, Options A/B/C), as in
``src/repro/core/client.py``.

The Q-step loop carries the *accumulated delta* rather than a second
parameter copy: w_q = w₀ − Δ_q and Δ_{q+1} = Δ_q + η ∇̃, the exact
telescoping of Algorithm 2 (Δ = w_{i,0} − w_{i,Q} = η Σ_q ∇̃).  Δ is kept in
``pcfg.delta_dtype``; each step's arithmetic is f32.  The reference's
``lax.scan`` is a Python loop here, and the function runs unchanged under
``torch.func.vmap`` over a cohort of clients.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.autodiff import grad
from repro_torch.core import maml as maml_mod
from repro_torch.core import moreau as me_mod
from repro_torch.core.maml import tree_norm
from repro_torch.core.types import PersAFLConfig
from repro_torch.tree import tree_leaves, tree_map

Loss = Callable

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _current_w(params, delta):
    return tree_map(lambda p, d: (p.float() - d.float()).to(p.dtype),
                    params, delta)


def client_update(pcfg: PersAFLConfig, loss_fn: Loss, params,
                  batches) -> Tuple:
    """Run Q local steps; return (delta tree, metrics dict).

    ``batches``: tree whose leaves have leading dim Q (Options A/C) or a
    dict {"d","dp","dpp"} of three such trees (Option B, the paper's three
    independent batches D, D′, D″).
    """
    option = pcfg.option
    if option not in ("A", "B", "C"):
        raise ValueError(f"unknown option {option!r}")
    acc_dtype = _DTYPES[pcfg.delta_dtype]
    delta = tree_map(lambda x: torch.zeros(x.shape, dtype=acc_dtype,
                                           device=x.device), params)
    q_steps = tree_leaves(batches)[0].shape[0]
    gnorms, nus = [], []
    for q in range(q_steps):
        batch_q = tree_map(lambda x: x[q], batches)
        w = _current_w(params, delta)
        nu = torch.zeros((), dtype=torch.float32,
                         device=tree_leaves(params)[0].device)
        if option == "A":
            g = grad(loss_fn)(w, batch_q)
        elif option == "B":
            g = maml_mod.maml_grad(loss_fn, w, batch_q["d"], batch_q["dp"],
                                   batch_q["dpp"], pcfg.alpha,
                                   mode=pcfg.maml_mode,
                                   hf_delta=pcfg.hf_delta)
        else:
            g, nu = me_mod.me_grad(loss_fn, w, batch_q, pcfg.lam,
                                   pcfg.inner_eta, pcfg.inner_steps)
        delta = tree_map(
            lambda d, gg: (d.float() + pcfg.eta * gg.float()).to(d.dtype),
            delta, g)
        gnorms.append(tree_norm(g))
        nus.append(nu)
    metrics = {"grad_norm_mean": torch.stack(gnorms).mean(),
               "delta_norm": tree_norm(delta),
               "nu_mean": torch.stack(nus).mean()}
    return delta, metrics


def split_batches_for_option(option: str, batches_3q):
    """Adapt a 3Q-leading-dim batch tree to the option's layout.

    The data pipeline always yields 3Q batches so all options consume the
    same stream; A/C use the first Q, B uses the (D, D′, D″) triple split.
    """
    q3 = tree_leaves(batches_3q)[0].shape[0]
    q = q3 // 3
    first = tree_map(lambda x: x[:q], batches_3q)
    if option in ("A", "C"):
        return first
    second = tree_map(lambda x: x[q:2 * q], batches_3q)
    third = tree_map(lambda x: x[2 * q:], batches_3q)
    return {"d": first, "dp": second, "dpp": third}
