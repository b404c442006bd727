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

The reference's ``"seq"`` mode and its dispatch for stacks that span several
devices (``src/repro/kernels/fused_update/ops.py:83-94``, ``:181-186``) come
with the port's multi-device slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.fused_update import ref as R
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_MODES = ("auto", "kernel", "ref")


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r} (the "
                         f"'seq' mode comes with the multi-device slice)")


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

    ``scale`` is a host float (β, β/M, or the damped β/(1+τ)^a)."""
    ws = tree_leaves(w_tree)
    if _tree_on_kernel(mode, ws):
        return tree_unflatten(
            w_tree, K.apply_scaled_leaves(ws, tree_leaves(d_tree), scale))
    return tree_map(lambda w, d: R.apply_scaled_ref(w, d, scale), w_tree,
                    d_tree)


def apply_rows_tree(w_tree, stack_tree, weights: torch.Tensor,
                    mode: str = "auto"):
    """Stacked server apply w ← w − Σᵢ weights[i]·Δᵢ per leaf: on the card
    one launch per tree.

    ``stack_tree`` is a DeltaBank buffer: a params-shaped tree whose leaves
    carry a leading ``[M]`` cohort axis; ``weights`` is the ``[M]`` float32
    row-weight vector on the params' device."""
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

    ``order`` (the serving window's admission order) is accepted and
    ignored: on one device every leaf reduces its rows in one pass, and the
    reference reads ``order`` only when the stack spans several devices
    (``src/repro/kernels/fused_update/ops.py:150-158``), which comes with
    the port's multi-device slice."""
    del order
    ws = tree_leaves(w_tree)
    if _tree_on_kernel(mode, ws):
        return tree_unflatten(
            w_tree, K.apply_rows_q_leaves(ws, tree_leaves(q_tree),
                                          tree_leaves(scales_tree), weights))
    return tree_map(lambda w, q, sc: R.apply_rows_q_ref(w, q, sc, weights),
                    w_tree, q_tree, scales_tree)
