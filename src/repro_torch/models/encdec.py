"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), as in
``src/repro/models/encdec.py``.

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the model consumes precomputed frame embeddings (B, enc_len, d).
Positions are sinusoidal in both stacks (the reference's noted deviation
from whisper's learned decoder positions); the MLPs are 2-matrix GELU
(tanh form, as ``jax.nn.gelu``'s default).

Params: ``{"embed": {"tok", "unembed"}, "enc_layers": {"ln1", "attn":
{"wq", "wk", "wv", "wo"}, "ln2", "mlp": {"w1", "w2"}}, "enc_norm",
"dec_layers": {"ln1", "self": {...}, "ln_x", "cross": {...}, "ln2", "mlp":
{...}}, "final_norm"}``, each stack's layers on a leading axis, as the
reference's init builds them (whisper-large-v3: 25 leaves), so that
``convert.params_from_jax`` and checkpoints carry across unchanged.

The reference scans over the stacked layers; here a Python loop takes layer
``i`` as ``{k: v[i]}``.  Every full-sequence attention goes through
``attention.FlashAttention`` (the CUDA kernel ``flash_attention_fwd`` when
the activations lie on the card, the plain ``attention_ref`` on the CPU):
the encoder's bidirectional self-attention (``causal=False``), the
decoder's causal self-attention, and its cross-attention from the decoder's
tokens to the encoder's frames (keys of another length, ``causal=False``);
one forward evaluation of the loss launches it ``enc_layers + 2 *
n_layers`` times.  Decode runs the plain ``sdpa`` against the self cache and
the cross K/V that :func:`init_encdec_cache` computes once.  ``cfg.remat``
changes memory, not numbers: it is accepted and ignored, as in
``models/lm.py``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (cross_entropy, embed_tokens,
                                       init_embed, init_mlp_gelu,
                                       init_rms_norm, mlp_gelu_forward,
                                       rms_norm, sinusoidal_positions,
                                       unembed)
from repro_torch.tree import tree_map


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_encdec(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """Params drawn on the CPU from ``generator`` (the reference's shapes and
    init laws, not its numbers), then moved to ``device``."""
    dev = resolve_device(device)
    d = cfg.d_model

    def enc_layer():
        return {"ln1": init_rms_norm(d),
                "attn": attn.init_attn(generator, cfg),
                "ln2": init_rms_norm(d),
                "mlp": init_mlp_gelu(generator, d, cfg.d_ff)}

    def dec_layer():
        return {"ln1": init_rms_norm(d),
                "self": attn.init_attn(generator, cfg),
                "ln_x": init_rms_norm(d),
                "cross": attn.init_attn(generator, cfg),
                "ln2": init_rms_norm(d),
                "mlp": init_mlp_gelu(generator, d, cfg.d_ff)}

    params = {"embed": init_embed(generator, cfg.vocab, d),
              "enc_layers": _stack([enc_layer()
                                    for _ in range(cfg.enc_layers)]),
              "enc_norm": init_rms_norm(d),
              "dec_layers": _stack([dec_layer()
                                    for _ in range(cfg.n_layers)]),
              "final_norm": init_rms_norm(d)}
    return tree_map(lambda x: x.to(dev), params)


def _layers(stacked):
    """The layers of a stack, each as ``{k: v[i]}``."""
    n = stacked["ln1"].shape[0]
    return [tree_map(lambda x: x[i], stacked) for i in range(n)]


def _positions(cfg: ArchConfig, h, offset: int = 0) -> torch.Tensor:
    """``h`` plus the sinusoidal positions offset .. offset + S - 1, both in
    the activation dtype."""
    pos = sinusoidal_positions(h.shape[1], cfg.d_model, offset, h.device)
    return h + pos.to(h.dtype)[None]


def encode(cfg: ArchConfig, params, frames) -> torch.Tensor:
    """frames (B, enc_len, d), the stubbed frontend's embeddings ->
    (B, enc_len, d) in the activation dtype."""
    h = _positions(cfg, frames.to(cfg.activation_dtype))
    for lp in _layers(params["enc_layers"]):
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        a, _ = attn.attn_forward(cfg, lp["attn"], x, positions=None,
                                 causal=False)
        h = h + a
        x = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + mlp_gelu_forward(lp["mlp"], x)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def decode_full(cfg: ArchConfig, params, tokens, enc_h) -> torch.Tensor:
    """Teacher-forced decoder (training, prefill): tokens (B, S) against
    enc_h (B, T, d) -> hidden (B, S, d), final-normed."""
    h = _positions(cfg, embed_tokens(params["embed"], tokens,
                                     cfg.activation_dtype))
    for lp in _layers(params["dec_layers"]):
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        a, _ = attn.attn_forward(cfg, lp["self"], x, positions=None,
                                 causal=True)
        h = h + a
        x = rms_norm(h, lp["ln_x"], cfg.norm_eps)
        a, _ = attn.attn_forward(cfg, lp["cross"], x, positions=None,
                                 kv_x=enc_h, causal=False)
        h = h + a
        x = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + mlp_gelu_forward(lp["mlp"], x)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def encdec_loss(cfg: ArchConfig, params, batch: Dict) -> torch.Tensor:
    """batch: frames (B, enc_len, d), tokens (B, S), labels (B, S)."""
    enc_h = encode(cfg, params, batch["frames"])
    h = decode_full(cfg, params, batch["tokens"], enc_h)
    logits = unembed(params["embed"], h, cfg.final_softcap)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    return cross_entropy(logits, torch.clamp(labels, min=0), mask)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg: ArchConfig, params, frames, max_len: int,
                      dtype) -> Dict:
    """Encode once; every decoder layer's cross K and V as one batched
    product over the stacked layers, (n_layers, B, enc_len, Hkv, hd) in
    ``dtype``; empty self caches of (n_layers, B, max_len, Hkv, hd)."""
    enc_h = encode(cfg, params, frames)
    B, T = enc_h.shape[:2]
    dt = enc_h.dtype
    hd = cfg.resolved_head_dim
    cross = params["dec_layers"]["cross"]
    L = cross["wk"].shape[0]

    def proj(w, b):
        # (1, B, T, d) @ (L, 1, d, Hkv * hd) -> (L, B, T, Hkv * hd)
        out = enc_h[None] @ cross[w].to(dt)[:, None]
        if b in cross:
            out = out + cross[b].to(dt)[:, None, None, :]
        return out.reshape(L, B, T, cfg.n_kv_heads, hd).to(dtype)

    shape = (L, B, max_len, cfg.n_kv_heads, hd)
    return {"cross_k": proj("wk", "bk"), "cross_v": proj("wv", "bv"),
            "self_k": torch.zeros(shape, dtype=dtype, device=enc_h.device),
            "self_v": torch.zeros(shape, dtype=dtype, device=enc_h.device)}


def encdec_decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """tokens (B, 1), pos an int -> (logits (B, 1, V), new cache)."""
    h = _positions(cfg, embed_tokens(params["embed"], tokens,
                                     cfg.activation_dtype), offset=pos)
    sk, sv = [], []
    for i, lp in enumerate(_layers(params["dec_layers"])):
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        a, k, v = attn.attn_decode(cfg, lp["self"], x, cache["self_k"][i],
                                   cache["self_v"][i], pos, rope=False)
        h = h + a
        sk.append(k)
        sv.append(v)
        x = rms_norm(h, lp["ln_x"], cfg.norm_eps)
        h = h + attn.cross_attn_decode(cfg, lp["cross"], x,
                                       cache["cross_k"][i],
                                       cache["cross_v"][i])
        x = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + mlp_gelu_forward(lp["mlp"], x)
    new = dict(cache, self_k=torch.stack(sk), self_v=torch.stack(sv))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], h, cfg.final_softcap), new
