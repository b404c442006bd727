"""Step functions, as in ``src/repro/launch/steps.py``: the PersA-FL train
step (one client round at the stale params, then the server apply), the
prefill and the one-token serve step.

PyTorch runs eagerly, so a step is the plain function the reference hands to
``jit``.  ``make_train_step`` computes the client delta with
:func:`repro_torch.core.client_update` at the STALE params w^{Ω(t)} and
applies w^{t+1} = w^t − β Δ to the server params through the server apply of
``core/server.py`` (``kernels.fused_update.ops.apply_delta_tree``: the CUDA
kernel ``apply_scaled``, one launch per tree, for a tree on the card; f32
arithmetic, stored in each leaf's dtype, out of place, so the server and
stale params may be one tree).

``make_cohort_train_step`` is the reference's FedBuff cohort round over a
``torch.distributed`` ``DeviceMesh``: each rank along the data axes is one
client on its block of the batch, and one ``all_reduce`` averages the
deltas and metrics (:func:`repro_torch.sharding.ctx.cohort_slice`).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import PersAFLConfig, client_update
from repro_torch.kernels.fused_update.ops import apply_delta_tree
from repro_torch.models import api
from repro_torch.sharding.ctx import cohort_slice
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def microbatched(loss_fn: Callable, n_mb: int) -> Callable:
    """``grad(microbatched(loss))`` equals gradient accumulation over
    ``n_mb`` slices of the batch's leading axis: the mean of the slice
    losses, summed in slice order from an f32 zero as the reference's scan
    sums them.

    The reference remats each slice (``jax.checkpoint``).  Here the slices
    run as a plain loop: ``torch.utils.checkpoint`` works through saved-tensor
    hooks or a reentrant backward, and ``torch.func.grad`` (which
    ``client_update`` differentiates with) refuses both, so the gradient is
    the reference's but every slice's activations stay alive until the
    backward, as for the whole batch."""
    if n_mb <= 1:
        return loss_fn

    def loss(params, batch):
        b = tree_map(lambda x: x.reshape((n_mb, x.shape[0] // n_mb)
                                         + tuple(x.shape[1:])), batch)
        total = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(batch)[0].device)
        for i in range(n_mb):
            total = total + loss_fn(params, tree_map(lambda x: x[i], b))
        return total / n_mb

    return loss


def make_loss(cfg: ArchConfig, n_mb: int = 1) -> Callable:
    def base(p, b):
        return api.loss_fn(cfg, p, b)

    return microbatched(base, n_mb)


def _q_batches(pcfg: PersAFLConfig, batch: Dict):
    """The round's batch broadcast over the Q local steps, as a view (the
    reference feeds one batch; a deployment streams fresh D_{i,q} per step
    -- the same computation).  Option B gets it as D, D′ and D″."""
    q = pcfg.q_local
    tiled = tree_map(lambda x: x[None].expand((q,) + tuple(x.shape)), batch)
    if pcfg.option == "B":
        return {"d": tiled, "dp": tiled, "dpp": tiled}
    return tiled


def make_train_step(cfg: ArchConfig, pcfg: PersAFLConfig,
                    n_microbatches: int = 0) -> Callable:
    """``train_step(server_params, stale_params, batch) -> (new_params,
    metrics)``: Q local steps (Option A/B/C) at ``stale_params``, then
    ``new = (w.float() − β·Δ).to(w.dtype)`` on ``server_params``."""
    n_mb = n_microbatches or cfg.train_microbatches
    loss = make_loss(cfg, n_mb)

    def train_step(server_params, stale_params, batch):
        delta, metrics = client_update(pcfg, loss, stale_params,
                                       _q_batches(pcfg, batch))
        return apply_delta_tree(server_params, delta, pcfg.beta), metrics

    return train_step


def make_cohort_train_step(cfg: ArchConfig, pcfg: PersAFLConfig, mesh,
                           n_microbatches: int = 0,
                           cohort_axes=None) -> Callable:
    """FedBuff-style cohort round over ``mesh`` (a ``DeviceMesh``): each
    rank along the data axes (``("data",)``, ``("pod", "data")`` with
    pods, or ``cohort_axes``) is an independent client running Q local
    steps at ``stale_params`` on its block of the batch (every rank passes
    the same global batch); the deltas and the metrics are averaged once
    at the end, one ``all_reduce`` per data axis of one flat f32 buffer
    (a sum divided by the client count: ``gloo`` has no average), and the
    server apply follows as in :func:`make_train_step`.  The model axis is
    left alone: params stay whole on every rank.  On a one-rank mesh it is
    :func:`make_train_step`, bit for bit."""
    n_mb = n_microbatches or cfg.train_microbatches
    loss = make_loss(cfg, n_mb)
    names = tuple(mesh.mesh_dim_names)
    d_axes = tuple(cohort_axes) if cohort_axes is not None \
        else (("pod", "data") if "pod" in names else ("data",))

    def train_step(server_params, stale_params, batch):
        sl = cohort_slice(mesh, tree_leaves(batch)[0].shape[0], d_axes)
        mine = tree_map(lambda x: x[sl.start:sl.stop], batch)
        delta, metrics = client_update(pcfg, loss, stale_params,
                                       _q_batches(pcfg, mine))
        if sl.count > 1:
            leaves = tree_leaves(delta) + [metrics[k] for k in sorted(metrics)]
            flat = sl.all_reduce(torch.cat(
                [x.float().reshape(-1) for x in leaves])) / sl.count
            parts = torch.split(flat, [x.numel() for x in leaves])
            means = [p.reshape(x.shape).to(x.dtype)
                     for p, x in zip(parts, leaves)]
            n = len(tree_leaves(delta))
            delta = tree_unflatten(delta, means[:n])
            metrics = dict(zip(sorted(metrics), means[n:]))
        return apply_delta_tree(server_params, delta, pcfg.beta), metrics

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch):
        return api.prefill_logits(cfg, params, batch)

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """One-token decode with the KV/SSM cache (decode_32k / long_500k)."""
    def serve_step(params, cache, tokens, pos):
        return api.decode_step(cfg, params, cache, tokens, pos)

    return serve_step
