"""Functional optimizers over the port's trees, as in
``src/repro/optim/optimizers.py``: each is ``(init, update)``.

``update(grads, opt_state, params) -> (updates, new_opt_state)``; apply with
:func:`apply_updates` (updates are *subtracted*, the SGD convention).  The
state is f32 (moments) with an int32 step counter, on the device of the
params; the arithmetic is f32 whatever the params' dtype.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() - u.float()).to(p.dtype),
                    params, updates)


def constant_lr(lr: float):
    return lambda step: lr


def cosine_lr(lr: float, total_steps: int, warmup: int = 0):
    """Linear warm-up over ``warmup`` steps, then a half cosine to 0 at
    ``total_steps``; ``step`` (an int or an int32 tensor) -> f32 tensor."""
    def sched(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        return lr * warm * 0.5 * (1 + torch.cos(math.pi * frac))
    return sched


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def sgd(lr) -> Optimizer:
    sched = lr if callable(lr) else constant_lr(lr)

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        lr_t = sched(state["step"])
        upd = tree_map(lambda g: lr_t * g.float(), grads)
        return upd, {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    sched = lr if callable(lr) else constant_lr(lr)

    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params)}

    def update(grads, state, params=None):
        m = tree_map(lambda mm, g: beta * mm + g.float(), state["m"], grads)
        lr_t = sched(state["step"])
        upd = tree_map(lambda mm: lr_t * mm, m)
        return upd, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    sched = lr if callable(lr) else constant_lr(lr)

    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params),
                "v": _zeros_f32(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g.float().square(),
                     state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr_t = sched(state["step"])
        upd = tree_map(
            lambda mm, vv: lr_t * (mm / bc1) / (torch.sqrt(vv / bc2) + eps),
            m, v)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
