"""Personalized evaluation (paper §5), as in ``src/repro/fl/evaluate.py``:
every method is scored by test accuracy *after the same local fine-tuning
budget* on each client's own data, then averaged over clients.

``personal_subset`` restricts the fine-tune to the personal leaves: the
backbone keeps the global values, so the score measures what a head-only
serving deployment delivers."""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.convert import to_tensor
from repro_torch.core.subset import SubsetSpec
from repro_torch.data.federated import ClientData, eval_batch
from repro_torch.tree import tree_leaves, tree_map


def make_personalized_eval(loss_fn: Callable, acc_fn: Callable,
                           clients: List[ClientData], *, ft_steps: int = 1,
                           ft_lr: float = 0.01, batch_size: int = 32,
                           eval_size: int = 64, seed: int = 0,
                           personal_subset=None,
                           with_loss: bool = False) -> Callable:
    """Returns eval(params) -> mean personalized test accuracy.

    Each client fine-tunes the global params for ``ft_steps`` SGD steps on
    its own training data and is scored on a fixed test batch; the clients
    run as one ``torch.func.vmap`` on the params' device.  ``with_loss=True``
    returns ``{"acc": ..., "loss": ...}``.  The returned ``evaluate`` is a
    pure function of ``params``: the fine-tune batches are drawn afresh from
    ``seed`` on every call.  With ``personal_subset`` (any
    :class:`SubsetSpec` spelling) only the personal leaves take fine-tune
    steps.
    """
    spec = SubsetSpec.resolve(personal_subset)
    test_host = tree_map(lambda *xs: np.stack(xs),
                         *[eval_batch(c, eval_size, seed) for c in clients])
    test_on = {}   # device -> the test batch copied there once

    def _personalize_and_score(params, ft_batches, test_b):
        mask = spec.mask(params) if spec is not None \
            else tree_map(lambda _: True, params)
        p_i = params
        for s in range(ft_steps):
            b = tree_map(lambda x: x[s], ft_batches)
            g = grad(loss_fn)(p_i, b)
            p_i = tree_map(lambda p, gg, m: (p.float() - ft_lr * gg.float())
                           .to(p.dtype) if m else p, p_i, g, mask)
        if with_loss:
            return acc_fn(p_i, test_b), loss_fn(p_i, test_b)
        return acc_fn(p_i, test_b)

    _batched = vmap(_personalize_and_score, in_dims=(None, 0, 0))

    def evaluate(params):
        if spec is not None:
            spec.validate(params)   # a typo'd subset fails loudly
        dev = tree_leaves(params)[0].device
        if dev not in test_on:
            test_on[dev] = tree_map(lambda x: to_tensor(x, dev), test_host)
        rng = np.random.RandomState(seed)
        per_client = []
        for c in clients:
            idx = rng.randint(0, c.n_train, (ft_steps, batch_size))
            per_client.append({"images": c.train_x[idx],
                               "labels": c.train_y[idx]})
        ft = tree_map(lambda *xs: to_tensor(np.stack(xs), dev), *per_client)
        out = _batched(params, ft, test_on[dev])
        if with_loss:
            acc_v, loss_v = out
            return {"acc": float(acc_v.mean()), "loss": float(loss_v.mean())}
        return float(out.mean())

    return evaluate
