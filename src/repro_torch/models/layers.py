"""Model building blocks of ``src/repro/models/layers.py`` that the paper
CNN needs: the fan-in truncated-normal init and the cross-entropy loss.

Params are nested dicts of tensors, as in the reference."""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (fan-in) init on the CPU, drawn from ``generator``.

    The distribution is the reference's (a standard normal cut at ±2, times
    ``scale``), but the numbers are not: JAX's ``truncated_normal`` and
    ``torch.nn.init.trunc_normal_`` draw differently from the same seed.
    Parity tests therefore load the JAX init through
    :func:`repro_torch.convert.params_from_jax`.
    """
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (scale * t).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE in f32. labels: integer; mask: 0/1 same shape."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
