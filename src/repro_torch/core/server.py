"""Algorithm 1 — asynchronous server, the main-path half of
``src/repro/core/server.py``.

Paper-faithful mode: on receiving Δ from any client, immediately
``w ← w − β Δ`` and bump the version counter t.  Staleness bookkeeping
(Assumption 1) tracks τ = t − Ω(t) per applied update.  The buffered variant
(FedBuff) applies M deltas as one ``w ← w − β/M ΣΔ`` round; ``FLRun``'s
buffered and sync schedules feed :func:`apply_buffered_rows` one stacked bank
and one row-weight vector per flush.

Every apply goes through ``kernels/fused_update``: ``apply_scaled`` for a
single delta, ``apply_rows`` for a stack, ``apply_rows_q`` for an int8
:class:`QuantStack`.  The scale ``β·(1+τ)^(-a)`` and the row weights are
computed in float32 on the host; the scale reaches the kernel as a by-value
float, so no apply waits on the device to read a scalar.  The counters of
:class:`ServerState` live on the host too.  Every apply is out of place (the
kernels write a new tensor), so the serving ring's snapshot of the pre-apply
params stays valid without the reference's donation switch.

The robust half (:func:`bank_row_norms`, :func:`mask_rows`,
:func:`scale_rows`, :func:`robust_admission_weights`,
:func:`robust_flush_weights`) reduces row norms on the device; only the
``[capacity]`` norm vector crosses to the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_tensor
from repro_torch.core.quant import QuantStack
from repro_torch.core.subset import leaf_paths, merge_subset, subset_like
from repro_torch.core.types import ServerState
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_update.ops import (apply_delta_tree,
                                                  apply_rows_q_tree,
                                                  apply_rows_tree)
from repro_torch.sharding.ctx import gather, rowwise
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


def _apply_stack(params, delta_stack, w: torch.Tensor, order=None):
    """The stacked apply of one bank: a full-model stack rewrites every
    leaf; a personal-subset stack (the pruned structure of
    :mod:`repro_torch.core.subset`) rewrites only the subset leaves and
    passes the backbone through as the same tensors.  A
    :class:`QuantStack` goes to ``apply_rows_q``.  ``order`` is the row
    order of a stack that spans devices."""
    quant = isinstance(delta_stack, QuantStack)
    q_tree = delta_stack.q if quant else delta_stack
    full = leaf_paths(q_tree) == leaf_paths(params)
    target = params if full else subset_like(params, q_tree)
    if quant:
        new = apply_rows_q_tree(target, delta_stack.q, delta_stack.scales, w,
                                order=order)
    else:
        new = apply_rows_tree(target, delta_stack, w, order=order)
    return new if full else merge_subset(params, new)


def apply_buffered_rows(state: ServerState, delta_stack, weights, count,
                        staleness_max, staleness_sum=0.0,
                        order=None) -> ServerState:
    """Stacked-buffer overload of :func:`apply_buffered`.

    ``delta_stack`` is a DeltaBank buffer — a params-shaped tree whose
    leaves carry a leading ``[M]`` cohort axis on the params' device, or a
    personal-subset tree of such leaves; ``weights`` the ``[M]`` f32
    row-weight vector (β/M, per-delta damping ``(1+τ_j)^{-a}``, padding
    masks).  On the card the whole flush is one ``apply_rows`` launch for
    the tree; ``count`` is the number of admitted rows, which the version
    counter advances by.

    A stack that spans devices (a sharded bank of ``cohort_impl=
    "shard_map"``, on the 1-D or 2-D mesh alike) takes the sequential
    apply: rows accumulate one at a time in ``order`` (row order when
    None), so the result is the same bits on every mesh layout.
    """
    dev = tree_leaves(state.params)[0].device
    w = torch.as_tensor(np.asarray(weights, np.float32)).to(
        dev, non_blocking=True)
    params = _apply_stack(state.params, delta_stack, w, order)
    return _advance(state, params, count, staleness_max, staleness_sum)


def apply_admitted_rows(state: ServerState, delta_stack, weights, count,
                        staleness_max, staleness_sum=0.0,
                        order=None) -> ServerState:
    """Serving-window overload of :func:`apply_buffered_rows`.

    The incoming state stays valid (no apply here writes in place): the
    serving ring keeps the pre-apply params as the closed window's
    snapshot, which stragglers admitted into a later window were computed
    against.  ``delta_stack`` may be a personal-subset stack (only the
    subset leaves are rewritten, the backbone passes through as the same
    tensors) and, under int8 delta banking, a :class:`QuantStack`, which
    goes to ``apply_rows_q`` without an f32 copy of the bank.  ``order`` is
    the window's admission order, a total order on the rows that does not
    depend on the mesh: on a stack that spans devices the rows accumulate
    in that order, so the post-advance params are the same bits on the 1-D
    ``("cohort",)`` and 2-D ``("cohort", "model")`` layouts, which place
    the same users at different bank rows.
    """
    return apply_buffered_rows(state, delta_stack, weights, count,
                               staleness_max, staleness_sum, order=order)


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def bank_row_norms(delta_stack) -> np.ndarray:
    """Per-row L2 norms of a stacked bank, reduced on the device; only the
    ``[capacity]`` f32 vector crosses to the host, never a delta row.  A
    :class:`QuantStack` reduces in the quantized domain (``|scale|·‖q‖``
    per leaf, exact for the symmetric codec).  Rows holding NaN/Inf give
    non-finite norms, which is how the robust weights find them."""
    tot = None
    delta_stack = gather(delta_stack)   # a sharded bank, whole
    if isinstance(delta_stack, QuantStack):
        for q, sc in zip(tree_leaves(delta_stack.q),
                         tree_leaves(delta_stack.scales)):
            s = torch.square(sc.float()) \
                * torch.sum(torch.square(_rows_view(q).float()), dim=1)
            tot = s if tot is None else tot + s
    else:
        for leaf in tree_leaves(delta_stack):
            s = torch.sum(torch.square(_rows_view(leaf).float()), dim=1)
            tot = s if tot is None else tot + s
    return torch.sqrt(tot).cpu().numpy()


def _rows_where(stack, keep: torch.Tensor):
    def one(x, kk):
        k = kk.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(k, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
    return tree_map(lambda x: rowwise(x, keep, one), stack)


def mask_rows(delta_stack, keep):
    """Zero the rows of a stacked bank where ``keep`` is False (one pass on
    the device).  A zero weight cannot neutralize a NaN row (0·NaN = NaN),
    so the robust path rewrites the storage before the apply.  A
    :class:`QuantStack` masks codes and scales alike."""
    q_tree = delta_stack.q if isinstance(delta_stack, QuantStack) \
        else delta_stack
    keep = torch.as_tensor(np.asarray(keep, bool)).to(
        tree_leaves(q_tree)[0].device)
    if isinstance(delta_stack, QuantStack):
        return QuantStack(q=_rows_where(delta_stack.q, keep),
                          scales=_rows_where(delta_stack.scales, keep))
    return _rows_where(delta_stack, keep)


def scale_rows(delta_stack, factors):
    """Per-row scaling of a stacked bank by a ``[capacity]`` f32 factor
    vector, one pass on the device; a :class:`QuantStack` scales its f32
    scale vectors only."""
    q_tree = delta_stack.q if isinstance(delta_stack, QuantStack) \
        else delta_stack
    f = torch.as_tensor(np.asarray(factors, np.float32)).to(
        tree_leaves(q_tree)[0].device)

    def one(x, fr):
        ff = fr.reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.float() * ff).to(x.dtype)

    def rows(tree):
        return tree_map(lambda x: rowwise(x, f, one), tree)
    if isinstance(delta_stack, QuantStack):
        return QuantStack(q=delta_stack.q, scales=rows(delta_stack.scales))
    return rows(delta_stack)


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


def robust_admission_weights(
        capacity: int, rows: List[Tuple[int, int]], norms, *, beta: float,
        count: int, damping: float = 0.0, tau_max: Optional[int] = None,
        method: str = "clip", clip_norm: Optional[float] = None,
        trim_frac: float = 0.1) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Byzantine-robust variants of :func:`admission_weights`, on the host,
    as ``src/repro/core/server.py`` computes them.

    ``norms`` is the ``[capacity]`` row-norm vector of
    :func:`bank_row_norms`.  ``"clip"`` scales an admission whose norm
    exceeds ``clip_norm`` (default 2 × the median of the finite admitted
    norms) down to it, on the base weight β/count; ``"trim"`` sorts the
    admissions by norm, drops ``ceil(trim_frac·k)`` from each tail (at
    least one survives) and splits β over the survivors.  Both drop
    non-finite rows, zero rows past ``tau_max`` and apply ``(1+τ)^-a``.

    Returns ``(weights, keep, info)``: the ``[capacity]`` f32 weights, a
    ``[capacity]`` bool mask that is False on non-finite rows (route the
    stack through :func:`mask_rows` when it is not all True), and the
    ``clipped`` / ``trimmed`` / ``nonfinite`` counts with the effective
    ``clip_norm``.
    """
    if method not in ("clip", "trim"):
        raise ValueError(f"robust method must be 'clip' or 'trim', "
                         f"got {method!r}")
    norms = np.asarray(norms, np.float64)
    keep = np.isfinite(norms)
    admissible = [(idx, tau) for idx, tau in rows
                  if tau_max is None or tau <= tau_max]
    finite = [(idx, tau) for idx, tau in admissible if keep[idx]]
    info = {"clipped": 0, "trimmed": 0,
            "nonfinite": len(admissible) - len(finite), "clip_norm": 0.0}
    w = np.zeros(capacity, np.float32)
    if not finite:
        return w, keep, info
    a_norms = np.array([norms[idx] for idx, _ in finite])
    if method == "clip":
        c = float(clip_norm) if clip_norm is not None \
            else 2.0 * float(np.median(a_norms))
        info["clip_norm"] = c
        for (idx, tau), nrm in zip(finite, a_norms):
            wt = beta / count
            if damping:
                wt *= (1.0 + tau) ** (-damping)
            if nrm > c and nrm > 0.0:
                wt *= c / nrm
                info["clipped"] += 1
            w[idx] += wt
    else:
        k = len(finite)
        cut = int(np.ceil(trim_frac * k))
        if 2 * cut >= k:
            cut = (k - 1) // 2
        order = np.argsort(a_norms, kind="stable")
        survivors = order[cut: k - cut]
        info["trimmed"] = k - len(survivors)
        for j in survivors:
            idx, tau = finite[j]
            wt = beta / len(survivors)
            if damping:
                wt *= (1.0 + tau) ** (-damping)
            w[idx] += wt
    return w, keep, info


def robust_flush_weights(
        groups, *, beta: float, count: int, damping: float = 0.0,
        tau_max: Optional[int] = None, method: str = "clip",
        clip_norm: Optional[float] = None,
        trim_frac: float = 0.1) -> Tuple[Dict, Dict]:
    """:func:`robust_admission_weights` for ONE flush spanning several
    banks, calibrated over all of the flush's admissions (a 1-row group
    cannot see that its own row is the outlier).

    ``groups`` maps a bank key to ``(bank, rows)``, ``bank`` with
    ``.stacked`` / ``.capacity`` and ``rows`` the ``(idx, tau)``
    admissions.  Clip computes one bound for the flush and delegates per
    bank; trim ranks the flush's admissions together and splits β over the
    survivors.  Returns ``({key: (weights, keep)}, info)``.
    """
    if method not in ("clip", "trim"):
        raise ValueError(f"robust method must be 'clip' or 'trim', "
                         f"got {method!r}")
    norms_by = {key: np.asarray(bank_row_norms(bank.stacked), np.float64)
                for key, (bank, _) in groups.items()}
    info = {"clipped": 0, "trimmed": 0, "nonfinite": 0, "clip_norm": 0.0}
    out = {}
    if method == "clip":
        admitted = np.array([norms_by[key][idx]
                             for key, (_, rows) in groups.items()
                             for idx, tau in rows
                             if tau_max is None or tau <= tau_max])
        finite = admitted[np.isfinite(admitted)]
        c = float(clip_norm) if clip_norm is not None \
            else (2.0 * float(np.median(finite)) if finite.size else 0.0)
        info["clip_norm"] = c
        for key, (bank, rows) in groups.items():
            w, keep, gi = robust_admission_weights(
                bank.capacity, rows, norms_by[key], beta=beta,
                count=count, damping=damping, tau_max=tau_max,
                method="clip", clip_norm=c)
            for stat in ("clipped", "trimmed", "nonfinite"):
                info[stat] += gi[stat]
            out[key] = (w, keep)
        return out, info
    entries = [(key, idx, tau, norms_by[key][idx])
               for key, (_, rows) in groups.items()
               for idx, tau in rows
               if tau_max is None or tau <= tau_max]
    finite_e = [e for e in entries if np.isfinite(e[3])]
    info["nonfinite"] = len(entries) - len(finite_e)
    survivors = []
    if finite_e:
        k = len(finite_e)
        cut = int(np.ceil(trim_frac * k))
        if 2 * cut >= k:
            cut = (k - 1) // 2
        order = np.argsort([e[3] for e in finite_e], kind="stable")
        survivors = [finite_e[j] for j in order[cut: k - cut]]
        info["trimmed"] = k - len(survivors)
    w_by = {key: np.zeros(bank.capacity, np.float32)
            for key, (bank, _) in groups.items()}
    for key, idx, tau, _ in survivors:
        wt = beta / len(survivors)
        if damping:
            wt *= (1.0 + tau) ** (-damping)
        w_by[key][idx] += wt
    return {key: (w_by[key], np.isfinite(norms_by[key]))
            for key in groups}, info


def staleness_stats(state: ServerState) -> Dict:
    t = np.maximum(np.float32(state.t), np.float32(1.0))
    return {"mean_staleness": np.float32(state.staleness_sum) / t,
            "max_staleness": state.staleness_max,
            "server_rounds": state.t}
