"""Tree fronts for the fused-update kernels, one launch per param leaf.

``mode`` picks the implementation per leaf:

  * ``"auto"``   -- the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor;
  * ``"kernel"`` -- the CUDA kernel (which raises on a CPU tensor);
  * ``"ref"``    -- the plain version on any device.

The reference's ``"seq"`` mode and its dispatch for stacks that span several
devices (``src/repro/kernels/fused_update/ops.py:83-94``, ``:181-186``) come
with the port's multi-device slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.fused_update import ref as R
from repro_torch.tree import tree_map

_MODES = ("auto", "kernel", "ref")


def _pick(kernel_fn, ref_fn, mode: str, leaf: torch.Tensor):
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r} (the "
                         f"'seq' mode comes with the multi-device slice)")
    if mode == "ref" or (mode == "auto" and leaf.device.type == "cpu"):
        return ref_fn
    return kernel_fn


def sgd_step_tree(w_tree, g_tree, eta: float, mode: str = "auto"):
    """Option A step w ← w − η·g over a params tree, one pass per leaf."""
    return tree_map(
        lambda w, g: _pick(K.sgd_step, R.sgd_step_ref, mode, w)(w, g, eta),
        w_tree, g_tree)


def prox_inner_tree(theta_tree, g_tree, w_tree, eta_in: float, lam: float,
                    mode: str = "auto"):
    """Option C inner step θ ← θ − η_in·(g + λ·(θ − w)) over a params tree,
    one pass per leaf."""
    return tree_map(
        lambda t, g, w: _pick(K.prox_inner, R.prox_inner_ref, mode, t)(
            t, g, w, eta_in, lam), theta_tree, g_tree, w_tree)


def prox_outer_tree(w_tree, theta_tree, eta: float, lam: float,
                    mode: str = "auto"):
    """Option C outer step w ← w − (ηλ)·(w − θ) over a params tree, one pass
    per leaf."""
    return tree_map(
        lambda w, t: _pick(K.prox_outer, R.prox_outer_ref, mode, w)(
            w, t, eta, lam), w_tree, theta_tree)


def apply_delta_tree(w_tree, d_tree, scale: float, mode: str = "auto"):
    """Server apply w ← w − s·Δ over a params tree, one pass per leaf.

    ``scale`` is a host float (β, β/M, or the damped β/(1+τ)^a)."""
    return tree_map(
        lambda w, d: _pick(K.apply_scaled, R.apply_scaled_ref, mode, w)(
            w, d, scale), w_tree, d_tree)


def apply_rows_tree(w_tree, stack_tree, weights: torch.Tensor,
                    mode: str = "auto"):
    """Stacked server apply w ← w − Σᵢ weights[i]·Δᵢ per leaf, one pass each.

    ``stack_tree`` is a DeltaBank buffer: a params-shaped tree whose leaves
    carry a leading ``[M]`` cohort axis; ``weights`` is the ``[M]`` float32
    row-weight vector on the params' device."""
    return tree_map(
        lambda w, d: _pick(K.apply_rows, R.apply_rows_ref, mode, w)(
            w, d, weights), w_tree, stack_tree)


def apply_rows_q_tree(w_tree, q_tree, scales_tree, weights: torch.Tensor,
                      mode: str = "auto", order=None):
    """Quantized stacked apply w ← w − Σᵢ weights[i]·scales[i]·qᵢ per leaf,
    one pass each, over the components of a :class:`QuantStack`: ``q_tree``
    (int8 leaves ``[M, ...]``) and ``scales_tree`` (f32 leaves ``[M]``).  No
    f32 copy of the bank is made.

    ``order`` (the serving window's admission order) is accepted and
    ignored: on one device every leaf reduces its rows in one pass, and the
    reference reads ``order`` only when the stack spans several devices
    (``src/repro/kernels/fused_update/ops.py:150-158``), which comes with
    the port's multi-device slice."""
    del order
    return tree_map(
        lambda w, q, sc: _pick(K.apply_rows_q, R.apply_rows_q_ref, mode, w)(
            w, q, sc, weights), w_tree, q_tree, scales_tree)
