"""Plain PyTorch oracle for the flash-attention kernel, as in
``src/repro/kernels/flash_attention/ref.py``: attention with materialized
logits, causal and sliding-window masking, GQA head grouping and the
optional logit softcap -- the semantics the CUDA kernel reproduces tile by
tile.

Its choices are the reference's: the product q·kᵀ in q's dtype, then the
logits in f32, scaled by hd^-0.5 after the product; the softcap before the
mask; masked logits set to NEG_INF = -1e30; the softmax in f32, and the
probabilities cast to q's dtype before the product with V.

:func:`attention_tiles_ref` is the plain model of the CUDA kernels'
numerics instead: it walks key tiles of ``block_k`` with the online softmax
in f32, as the kernels do, so that the card's result can be held against
the arithmetic it is meant to do as well as against the reference's.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd); Hq % Hkv == 0 -> (B,S,Hq,hd).
    Query row i sits at key position ``q_offset + i`` (0: the queries are
    the keys' own positions; T - S: the last S rows of a sequence, held
    against all its keys without the logits of the rows before)."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, S, Hkv, group, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    logits = logits * (hd ** -0.5)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    qi = q_offset + torch.arange(S, device=q.device)[:, None]
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


def attention_tiles_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, block_k: int = 128,
                        q_offset: int = 0) -> torch.Tensor:
    """The kernels' arithmetic, key tile by key tile (``block_k`` keys from
    key 0): scores as f32 sums of the exact products of q's and k's values
    (for bf16 inputs, what wgmma's f32 accumulators hold), scaled by
    hd^-0.5, capped, masked by select to -inf; the online softmax in f32
    (a row with no live key yet rescales by 1, and weighs masked keys
    exactly 0); l sums the f32 weights, while P·V takes the weights rounded
    to v's dtype (bf16 pairs in wgmma's register fragment; no rounding in
    f32); out = acc / l in q's dtype.  q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd)
    -> (B,S,Hq,hd); ``q_offset`` as in :func:`attention_ref`."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    dev = q.device
    qf = q.float().reshape(B, S, Hkv, group, hd)
    qi = q_offset + torch.arange(S, device=dev)[:, None]
    inf = float("inf")
    m = torch.full((B, Hkv, group, S), -inf, device=dev)
    l = torch.zeros((B, Hkv, group, S), device=dev)
    acc = torch.zeros((B, Hkv, group, S, hd), device=dev)
    for k0 in range(0, T, block_k):
        kt = k[:, k0:k0 + block_k].float()
        s = torch.einsum("bskgh,btkh->bkgst", qf, kt) * (hd ** -0.5)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kj = torch.arange(k0, k0 + kt.shape[1], device=dev)[None, :]
        live = torch.ones((S, kt.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            live = live & (kj <= qi)
        if window:
            live = live & (kj > qi - window)
        s = torch.where(live, s, torch.full_like(s, -inf))
        m_new = torch.maximum(m, s.amax(dim=-1))
        dead = m_new == -inf
        alpha = torch.where(dead, torch.ones_like(m), torch.exp(m - m_new))
        m_use = torch.where(dead, torch.zeros_like(m_new), m_new)
        p = torch.exp(s - m_use[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkh->bkgsh", p.to(v.dtype).float(),
                          v[:, k0:k0 + block_k].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, hd).to(q.dtype)
