"""Algorithm 1 — asynchronous server, the main-path half of
``src/repro/core/server.py``.

Paper-faithful mode: on receiving Δ from any client, immediately
``w ← w − β Δ`` and bump the version counter t.  Staleness bookkeeping
(Assumption 1) tracks τ = t − Ω(t) per applied update.  The buffered variant
(FedBuff) applies M deltas as one ``w ← w − β/M ΣΔ`` round; ``FLRun``'s
buffered and sync schedules feed :func:`apply_buffered_rows` one stacked bank
and one row-weight vector per flush.

Every apply goes through ``kernels/fused_update``: ``apply_scaled`` for a
single delta, ``apply_rows`` for a stack.  The scale ``β·(1+τ)^(-a)`` and the
row weights are computed in float32 on the host; the scale reaches the kernel
as a by-value float, so no apply waits on the device to read a scalar.  The
counters of :class:`ServerState` live on the host too.

The robust half (row norms, clip/trim weights, row masks and scales) and the
non-donating serving apply wait for later slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_tensor
from repro_torch.core.types import ServerState
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_update.ops import (apply_delta_tree,
                                                  apply_rows_tree)
from repro_torch.tree import tree_leaves, tree_map


def init_server_state(params, device="cuda") -> ServerState:
    """Server state at t = 0 with ``params`` (tensors or numpy arrays)
    copied onto ``device``."""
    dev = resolve_device(device)
    return ServerState(params=tree_map(lambda x: to_tensor(x, dev), params),
                       t=np.int32(0), staleness_sum=np.float32(0.0),
                       staleness_max=np.int32(0))


def _on(x, device: torch.device) -> torch.Tensor:
    # a host row of a materialized bank (or a numpy delta) onto the params'
    # device; tensors already there pass through
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return to_tensor(x, device)


def _advance(state: ServerState, params, count, staleness_max,
             staleness_sum) -> ServerState:
    return ServerState(
        params=params,
        t=np.int32(state.t + np.int32(count)),
        staleness_sum=np.float32(state.staleness_sum
                                 + np.float32(staleness_sum)),
        staleness_max=np.maximum(state.staleness_max,
                                 np.int32(staleness_max)))


def apply_update(state: ServerState, delta, beta: float, staleness,
                 damping: float = 0.0) -> ServerState:
    """Paper-faithful single-delta apply (Algorithm 1 step 4).

    ``damping`` > 0 enables the FedAsync-style polynomial staleness
    discount s(τ) = (1+τ)^(-damping) on the server stepsize (beyond-paper;
    0 keeps the theorems' constant β).
    """
    staleness = np.int32(staleness)
    scale = np.float32(beta) * (np.float32(1.0) + np.float32(staleness)) \
        ** np.float32(-np.float32(damping))
    dev = tree_leaves(state.params)[0].device
    delta = tree_map(lambda d: _on(d, dev), delta)
    params = apply_delta_tree(state.params, delta, float(scale))
    return _advance(state, params, 1, staleness, staleness)


def apply_buffered(state: ServerState, delta_sum, count, beta: float,
                   staleness_max, staleness_sum=0.0) -> ServerState:
    """FedBuff-style buffered apply: w ← w − β/M Σ Δ (one server round).

    ``count`` is the number of contributing clients M and ``staleness_sum``
    the Σ τ over their deltas (the version counter advances by M)."""
    scale = np.float32(beta) / np.maximum(np.float32(count), np.float32(1.0))
    dev = tree_leaves(state.params)[0].device
    delta_sum = tree_map(lambda d: _on(d, dev), delta_sum)
    params = apply_delta_tree(state.params, delta_sum, float(scale))
    return _advance(state, params, count, staleness_max, staleness_sum)


def apply_buffered_rows(state: ServerState, delta_stack, weights, count,
                        staleness_max, staleness_sum=0.0) -> ServerState:
    """Stacked-buffer overload of :func:`apply_buffered`.

    ``delta_stack`` is a DeltaBank buffer — a params-shaped tree whose
    leaves carry a leading ``[M]`` cohort axis on the params' device;
    ``weights`` the ``[M]`` f32 row-weight vector (β/M, per-delta damping
    ``(1+τ_j)^{-a}``, padding masks).  The whole flush is one ``apply_rows``
    pass per leaf; ``count`` is the number of admitted rows, which the
    version counter advances by.
    """
    dev = tree_leaves(state.params)[0].device
    w = torch.as_tensor(np.asarray(weights, np.float32)).to(
        dev, non_blocking=True)
    params = apply_rows_tree(state.params, delta_stack, w)
    return _advance(state, params, count, staleness_max, staleness_sum)


def admission_weights(capacity: int, rows: List[Tuple[int, int]], *,
                      beta: float, count: int, damping: float = 0.0,
                      tau_max: Optional[int] = None) -> np.ndarray:
    """``[capacity]`` f32 row-weight vector for a stacked-bank server apply.

    ``rows`` is ``[(row_index, staleness τ), ...]``; every listed row gets
    ``β/count · (1+τ)^(-damping)`` and every other slot (bucket padding,
    unadmitted rows) gets 0.  With ``tau_max`` set, rows staler than the
    bound are zeroed (Assumption 1's τ ≤ τ_max).
    """
    w = np.zeros(capacity, np.float32)
    for idx, tau in rows:
        if tau_max is not None and tau > tau_max:
            continue
        wt = beta / count
        if damping:
            wt *= (1.0 + tau) ** (-damping)
        # accumulate, don't overwrite: a row admitted twice in one window
        # contributes twice while the version counter advances per admission
        w[idx] += wt
    return w


def staleness_stats(state: ServerState) -> Dict:
    t = np.maximum(np.float32(state.t), np.float32(1.0))
    return {"mean_staleness": np.float32(state.staleness_sum) / t,
            "max_staleness": state.staleness_max,
            "server_rounds": state.t}
