"""Model building blocks of ``src/repro/models/layers.py``: the fan-in
truncated-normal init, the cross-entropy loss, and what the SSM language
model needs (RMSNorm, logit soft-capping, the token embedding and the
unembedding).  Rotary embeddings and the MLPs come with the attention
families.

Params are nested dicts of tensors, as in the reference.  Stacked
(per-layer) params carry a leading ``n_layers`` axis."""
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


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 (bf16-safe), cast back to the input dtype; gemma-style
    ``(1 + gamma)`` scale."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(dtype)


def init_rms_norm(d: int) -> torch.Tensor:
    # gemma-style (1 + gamma) parameterization; init gamma = 0
    return torch.zeros((d,), dtype=torch.float32)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Logit soft-capping (gemma2): cap * tanh(x / cap)."""
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)


def init_embed(generator: torch.Generator, vocab: int, d_model: int):
    return {"tok": dense_init(generator, (vocab, d_model), scale=1.0),
            "unembed": dense_init(generator, (d_model, vocab))}


def embed_tokens(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the token table, cast to ``dtype``.  The reference casts the
    whole table and then gathers; gathering first gives the same numbers
    without a cast copy of the table."""
    return p["tok"][tokens.long()].to(dtype)


def unembed(p, h: torch.Tensor, final_softcap: float = 0.0) -> torch.Tensor:
    logits = h.float() @ p["unembed"].float()
    return softcap(logits, final_softcap)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE in f32.  labels: any integer dtype (int32 as the
    reference's token streams give them; converted to int64 for the
    gather); mask: 0/1 same shape."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
