"""Plain PyTorch oracle for the flash-attention kernel, as in
``src/repro/kernels/flash_attention/ref.py``: attention with materialized
logits, causal and sliding-window masking, GQA head grouping and the
optional logit softcap -- the semantics the CUDA kernel reproduces tile by
tile.

Its choices are the reference's: the product q·kᵀ in q's dtype, then the
logits in f32, scaled by hd^-0.5 after the product; the softcap before the
mask; masked logits set to NEG_INF = -1e30; the softmax in f32, and the
probabilities cast to q's dtype before the product with V.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd); Hq % Hkv == 0 -> (B,S,Hq,hd)."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, S, Hkv, group, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    logits = logits * (hd ** -0.5)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window:
        mask = mask & (kj > qi - window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, Hq, hd)
