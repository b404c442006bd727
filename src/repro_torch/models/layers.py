"""Model building blocks of ``src/repro/models/layers.py``: the fan-in
truncated-normal init, the cross-entropy loss, what the SSM language model
needs (RMSNorm, logit soft-capping, the token embedding and the
unembedding), what the hybrid's shared block needs (rotary embeddings, the
SwiGLU MLP), and what the encdec family needs (the 2-matrix GELU MLP and
the sinusoidal positions).

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


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Angles in
    f32, the two halves of the head rotated, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs   # (...,S,1,hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             d_in: Optional[int] = None):
    d_in = d_in or d_model
    return {"wg": dense_init(generator, (d_in, d_ff)),
            "wu": dense_init(generator, (d_in, d_ff)),
            "wd": dense_init(generator, (d_ff, d_model))}


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = torch.nn.functional.silu(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    return h @ p["wd"].to(dt)


# ---------------------------------------------------------------------------
# GELU MLP and sinusoidal positions (whisper)
# ---------------------------------------------------------------------------

def init_mlp_gelu(generator: torch.Generator, d_model: int, d_ff: int):
    """2-matrix GELU MLP (whisper-style), the reference's param count."""
    return {"w1": dense_init(generator, (d_model, d_ff)),
            "w2": dense_init(generator, (d_ff, d_model))}


def mlp_gelu_forward(p, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation, not the exact
    erf form that ``F.gelu`` defaults to."""
    dt = x.dtype
    h = torch.nn.functional.gelu(x @ p["w1"].to(dt), approximate="tanh")
    return h @ p["w2"].to(dt)


_SIN_TABLES: dict = {}


def _sinusoidal_table(rows: int, d: int, device) -> torch.Tensor:
    """The (>= rows, d) table of positions 0, 1, ... on ``device``, grown
    (to at least twice its length) only when a call needs more rows."""
    table = _SIN_TABLES.get((d, device))
    if table is None or table.shape[0] < rows:
        n = max(rows, 2048 if table is None else 2 * table.shape[0])
        pos = torch.arange(n, dtype=torch.float32)[:, None]
        div = 1.0 / (10_000.0 ** (torch.arange(0, d, 2, dtype=torch.float32)
                                  / d))
        ang = pos * div[None, :]
        table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        _SIN_TABLES[(d, device)] = table = table.to(device)
    return table


def sinusoidal_positions(n: int, d: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """(n, d) f32 sinusoidal position embeddings (whisper enc/dec) of
    positions offset .. offset + n - 1, a view of one table per (d,
    device).  The table is computed on the host in f32, as the reference
    computes it, and copied to ``device`` once: a card and the CPU then add
    the same bits (the angles reach 1,500 radians, where an ulp of the
    device's ``pow`` would move them by 1e-4), and a decode step slices it
    on the device with no copy."""
    offset = int(offset)
    table = _sinusoidal_table(offset + int(n), int(d),
                              torch.device(device or "cpu"))
    return table[offset:offset + int(n)]


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
