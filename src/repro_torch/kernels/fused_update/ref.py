"""Plain PyTorch versions of the server-apply kernels.

Server apply:  w ← w − s·Δ
Stacked apply: w ← w − Σᵢ sᵢ·Δᵢ   (fp32 bank rows, one reduction)
Quantized:     w ← w − Σᵢ (sᵢ·scaleᵢ)·qᵢ   (int8 bank rows, f32 row scales)

The arithmetic is f32 and the result keeps ``w``'s storage dtype, as in
``src/repro/kernels/fused_update/ref.py``.  These run for CPU tensors (the
tests), and ``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import numpy as np
import torch


def apply_scaled_ref(w: torch.Tensor, d: torch.Tensor, scale) -> torch.Tensor:
    """Server apply w ← w − s·Δ, with ``s`` rounded to f32 first."""
    s = float(np.float32(scale))
    return (w.float() - s * d.float()).to(w.dtype)


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
