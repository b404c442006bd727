"""Tree fronts for the fused-update kernels.

Every front launches once per param tree on the card (per dtype
combination and chunk of the kernel's table of leaves, see
``kernel.plan_launches``).

``mode`` picks the implementation:

  * ``"auto"``   -- the CUDA kernel for a tree on the card, the plain version
    for a tree on the CPU;
  * ``"kernel"`` -- the CUDA kernel (which raises on a CPU tensor);
  * ``"ref"``    -- the plain version on any device, one call per leaf.

In ``"auto"`` and ``"kernel"`` a tree whose leaves sit on several devices
raises.  A tree front pairs the leaves of its trees in ``tree_leaves``
order, so the trees must share one structure; the kernel path checks their
leaf counts and shapes.

The stacked applies take a fourth mode, as the reference's
(``src/repro/kernels/fused_update/ops.py:83-186``):

  * ``"seq"`` -- the plain sequential apply (``ref.apply_rows_seq_ref``):
    rows added one at a time in ``order`` (row order when None), so the
    result does not depend on how the stack is split over ranks.

``"auto"`` takes ``"seq"`` for a stack that spans devices (a DTensor over
more than one rank, :func:`repro_torch.sharding.ctx.spans_devices`).  Each
rank then gathers the stack's rows over the "cohort" axis, cut to its own
piece of each param, and applies them to that piece; the params keep their
placement.  A stack on a one-rank mesh spans no devices and goes to the
kernel on its local tensors, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.fused_update import ref as R
from repro_torch.sharding.ctx import (is_sharded, like, local, piece_like,
                                      rows_like, spans_devices)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_MODES = ("auto", "kernel", "ref")
_ROW_MODES = _MODES + ("seq",)


def _check_mode(mode: str, modes=_MODES) -> None:
    if mode not in modes:
        raise ValueError(f"mode must be one of {modes}, got {mode!r}")


def _tree_on_kernel(mode: str, leaves) -> bool:
    """Whether a tree of ``leaves`` goes to the kernel, decided once for
    the tree by its first leaf.  Leaves on several devices raise unless
    ``mode`` is ``"ref"``: the kernel's wrapper refuses a leaf off the first
    one's card, and a tree whose first leaf is not on a card is checked
    here."""
    _check_mode(mode)
    if mode == "ref" or not leaves:
        return False
    if mode == "kernel" or leaves[0].is_cuda:
        return True
    devices = {x.device for x in leaves}
    if len(devices) > 1:
        raise ValueError(f"the tree's leaves sit on several devices "
                         f"({sorted(map(str, devices))}); the kernel takes "
                         f"one card")
    return False


def sgd_step_tree(w_tree, g_tree, eta: float, mode: str = "auto"):
    """Option A step w ← w − η·g over a params tree: on the card one launch
    per tree."""
    ws = tree_leaves(w_tree)
    if _tree_on_kernel(mode, ws):
        return tree_unflatten(
            w_tree, K.sgd_step_leaves(ws, tree_leaves(g_tree), eta))
    return tree_map(lambda w, g: R.sgd_step_ref(w, g, eta), w_tree, g_tree)


def prox_inner_tree(theta_tree, g_tree, w_tree, eta_in: float, lam: float,
                    mode: str = "auto"):
    """Option C inner step θ ← θ − η_in·(g + λ·(θ − w)) over a params tree:
    on the card one launch per tree."""
    ts = tree_leaves(theta_tree)
    if _tree_on_kernel(mode, ts):
        return tree_unflatten(
            theta_tree, K.prox_inner_leaves(ts, tree_leaves(g_tree),
                                            tree_leaves(w_tree), eta_in, lam))
    return tree_map(lambda t, g, w: R.prox_inner_ref(t, g, w, eta_in, lam),
                    theta_tree, g_tree, w_tree)


def prox_outer_tree(w_tree, theta_tree, eta: float, lam: float,
                    mode: str = "auto"):
    """Option C outer step w ← w − (ηλ)·(w − θ) over a params tree: on the
    card one launch per tree."""
    ws = tree_leaves(w_tree)
    if _tree_on_kernel(mode, ws):
        return tree_unflatten(
            w_tree, K.prox_outer_leaves(ws, tree_leaves(theta_tree), eta,
                                        lam))
    return tree_map(lambda w, t: R.prox_outer_ref(w, t, eta, lam), w_tree,
                    theta_tree)


def apply_delta_tree(w_tree, d_tree, scale: float, mode: str = "auto"):
    """Server apply w ← w − s·Δ over a params tree: on the card one launch
    per tree.

    ``scale`` is a host float (β, β/M, or the damped β/(1+τ)^a).  Placed
    params (DTensor leaves) are applied on this rank's piece, with the
    matching piece of each delta leaf, and keep their placement."""
    if _any_sharded(w_tree):
        return _on_pieces(
            lambda w, d: apply_delta_tree(w, d, scale, mode), w_tree,
            tree_map(piece_like, d_tree, w_tree))
    ws = tree_leaves(w_tree)
    if _tree_on_kernel(mode, ws):
        return tree_unflatten(
            w_tree, K.apply_scaled_leaves(ws, tree_leaves(d_tree), scale))
    return tree_map(lambda w, d: R.apply_scaled_ref(w, d, scale), w_tree,
                    d_tree)


def _any_sharded(*trees) -> bool:
    return any(is_sharded(x) for t in trees for x in tree_leaves(t))


def _on_pieces(fn, w_tree, *pieces):
    """``fn`` on the local pieces of placed params ``w_tree`` and the plain
    ``pieces`` trees cut to match them; the result placed as ``w_tree``."""
    out = fn(tree_map(local, w_tree), *pieces)
    return tree_map(like, out, w_tree)


def _order(stack_tree, order):
    if order is None:
        return np.arange(tree_leaves(stack_tree)[0].shape[0])
    return np.asarray(order, np.int64)


def apply_rows_tree(w_tree, stack_tree, weights: torch.Tensor,
                    mode: str = "auto", order=None):
    """Stacked server apply w ← w − Σᵢ weights[i]·Δᵢ per leaf: on the card
    one launch per tree.

    ``stack_tree`` is a DeltaBank buffer: a params-shaped tree whose leaves
    carry a leading ``[M]`` cohort axis; ``weights`` is the ``[M]`` float32
    row-weight vector on the params' device.  ``order`` is the row order of
    the ``"seq"`` mode (a stack that spans devices takes it)."""
    _check_mode(mode, _ROW_MODES)
    if mode == "auto" and spans_devices(stack_tree):
        mode = "seq"
    if mode == "seq":
        order = _order(stack_tree, order)
        return tree_map(lambda w, d: like(R.apply_rows_seq_ref(
            local(w), rows_like(d, w), weights, order), w),
            w_tree, stack_tree)
    if _any_sharded(w_tree, stack_tree):
        return _on_pieces(
            lambda w, d: apply_rows_tree(w, d, weights, mode), w_tree,
            tree_map(rows_like, stack_tree, w_tree))
    ws = tree_leaves(w_tree)
    if _tree_on_kernel(mode, ws):
        return tree_unflatten(
            w_tree, K.apply_rows_leaves(ws, tree_leaves(stack_tree),
                                        weights))
    return tree_map(lambda w, d: R.apply_rows_ref(w, d, weights), w_tree,
                    stack_tree)


def apply_rows_q_tree(w_tree, q_tree, scales_tree, weights: torch.Tensor,
                      mode: str = "auto", order=None):
    """Quantized stacked apply w ← w − Σᵢ weights[i]·scales[i]·qᵢ per leaf
    over the components of a :class:`QuantStack`: ``q_tree`` (int8 leaves
    ``[M, ...]``) and ``scales_tree`` (f32 leaves ``[M]``, each leaf's own);
    on the card one launch per tree.  No f32 copy of the bank is made.
    ``order`` is the ``"seq"`` mode's row order (the serving window's
    admission order), as in :func:`apply_rows_tree`."""
    _check_mode(mode, _ROW_MODES)
    if mode == "auto" and spans_devices(q_tree):
        mode = "seq"
    if mode == "seq":
        order = _order(q_tree, order)
        return tree_map(lambda w, q, sc: like(R.apply_rows_q_seq_ref(
            local(w), rows_like(q, w), rows_like(sc, None), weights,
            order), w), w_tree, q_tree, scales_tree)
    if _any_sharded(w_tree, q_tree):
        return _on_pieces(
            lambda w, q, sc: apply_rows_q_tree(w, q, sc, weights, mode),
            w_tree, tree_map(rows_like, q_tree, w_tree),
            tree_map(lambda sc: rows_like(sc, None), scales_tree))
    ws = tree_leaves(w_tree)
    if _tree_on_kernel(mode, ws):
        return tree_unflatten(
            w_tree, K.apply_rows_q_leaves(ws, tree_leaves(q_tree),
                                          tree_leaves(scales_tree), weights))
    return tree_map(lambda w, q, sc: R.apply_rows_q_ref(w, q, sc, weights),
                    w_tree, q_tree, scales_tree)
