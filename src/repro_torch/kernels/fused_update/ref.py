"""Plain PyTorch versions of the fused-update kernels.

Option A step:   w ← w − η·g
Option C inner:  θ ← θ − η_in·(g + λ·(θ − w))
Option C outer:  w ← w − (ηλ)·(w − θ)
Server apply:  w ← w − s·Δ
Stacked apply: w ← w − Σᵢ sᵢ·Δᵢ   (fp32 bank rows, one reduction)
Quantized:     w ← w − Σᵢ (sᵢ·scaleᵢ)·qᵢ   (int8 bank rows, f32 row scales)
Sequential:    the two stacked applies with rows added one at a time

The arithmetic is f32 and the result keeps the first operand's storage
dtype, as in ``src/repro/kernels/fused_update/ref.py``.  Host scalars are
rounded to f32 where the reference's weakly typed Python floats are: each
of η, η_in and λ on its own, but ηλ of the outer step as one Python double
product rounded once (``eta * lam * (w − θ)`` multiplies the two floats
before the array), which differs from f32(η)·f32(λ) in the last bit for
some pairs (η = 0.01, λ = 20).  These run for CPU tensors (the tests),
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


def sgd_step_ref(w: torch.Tensor, g: torch.Tensor, eta: float
                 ) -> torch.Tensor:
    """Option A step w ← w − η·g."""
    return (w.float() - _f32(eta) * g.float()).to(w.dtype)


def prox_inner_ref(theta: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                   eta_in: float, lam: float) -> torch.Tensor:
    """Option C inner step θ ← θ − η_in·(g + λ·(θ − w))."""
    t32 = theta.float()
    return (t32 - _f32(eta_in) * (g.float() + _f32(lam) * (t32 - w.float()))
            ).to(theta.dtype)


def prox_outer_ref(w: torch.Tensor, theta: torch.Tensor, eta: float,
                   lam: float) -> torch.Tensor:
    """Option C outer step w ← w − (ηλ)·(w − θ), ηλ rounded to f32 once."""
    w32 = w.float()
    return (w32 - _f32(eta * lam) * (w32 - theta.float())).to(w.dtype)


def apply_scaled_ref(w: torch.Tensor, d: torch.Tensor, scale) -> torch.Tensor:
    """Server apply w ← w − s·Δ, with ``s`` rounded to f32 first."""
    return (w.float() - _f32(scale) * d.float()).to(w.dtype)


def apply_rows_ref(w: torch.Tensor, d_stack: torch.Tensor,
                   weights) -> torch.Tensor:
    """Stacked server apply w ← w − Σᵢ sᵢ·Δᵢ in one reduction.

    ``d_stack`` is ``[M, *w.shape]``; ``weights`` the ``[M]`` f32 vector
    carrying β/M, per-row staleness damping and padding masks (zero rows
    contribute nothing).
    """
    s = torch.as_tensor(weights, dtype=torch.float32, device=w.device)
    s = s.reshape((-1,) + (1,) * w.dim())
    acc = torch.sum(s * d_stack.float(), dim=0)
    return (w.float() - acc).to(w.dtype)


def apply_rows_q_ref(w: torch.Tensor, q_stack: torch.Tensor, scales,
                     weights) -> torch.Tensor:
    """Quantized stacked apply w ← w − Σᵢ sᵢ·scaleᵢ·qᵢ in one reduction.

    ``q_stack`` is the int8 ``[M, *w.shape]`` bank buffer, ``scales`` its
    ``[M]`` f32 per-row dequantization scales and ``weights`` the same
    ``[M]`` admission weights as :func:`apply_rows_ref`.  The coefficient
    ``weights[i]·scales[i]`` is formed in f32 and multiplies ``qᵢ`` cast to
    f32: the dequant is folded into the reduction, never a pass of its own.
    """
    coeff = (torch.as_tensor(weights, dtype=torch.float32, device=w.device)
             * torch.as_tensor(scales, dtype=torch.float32, device=w.device))
    coeff = coeff.reshape((-1,) + (1,) * w.dim())
    acc = torch.sum(coeff * q_stack.float(), dim=0)
    return (w.float() - acc).to(w.dtype)


def apply_rows_seq_ref(w: torch.Tensor, d_stack: torch.Tensor, weights,
                       order) -> torch.Tensor:
    """Order-invariant stacked apply: rows accumulate one at a time in f32,
    in ``order`` (a permutation of the ``M`` rows), as
    ``src/repro/kernels/fused_update/ref.py``'s ``apply_rows_seq_ref``.
    Every step is elementwise, so the result is the same bits however the
    stack's rows and row dims are split over ranks: the serving window's
    flush passes its admission order, the same on every mesh layout.
    Zero-weight padding rows add an exact ``+0``."""
    s = torch.as_tensor(weights, dtype=torch.float32, device=w.device)
    acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for j in np.asarray(order, np.int64):
        acc = acc + s[j] * d_stack[j].float()
    return (w.float() - acc).to(w.dtype)


def apply_rows_q_seq_ref(w: torch.Tensor, q_stack: torch.Tensor, scales,
                         weights, order) -> torch.Tensor:
    """Quantized twin of :func:`apply_rows_seq_ref`: the dequant folded into
    the f32 per-row coefficient ``weights[i]·scales[i]``, rows accumulated
    one at a time in ``order``."""
    coeff = (torch.as_tensor(weights, dtype=torch.float32, device=w.device)
             * torch.as_tensor(scales, dtype=torch.float32, device=w.device))
    acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for j in np.asarray(order, np.int64):
        acc = acc + coeff[j] * q_stack[j].float()
    return (w.float() - acc).to(w.dtype)
