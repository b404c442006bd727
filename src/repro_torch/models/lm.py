"""Decoder-only LM of the dense and vlm families, as in
``src/repro/models/lm.py``: GQA with optional QKV bias (qwen), logit softcaps,
post-block norms, the embedding scale and local/global alternation
(gemma2), and the vlm family's stubbed visual prefix (precomputed patch
embeddings through ``vis_proj``, prepended to the text stream; the ViT is
not implemented, as in the reference).

Params: ``{"embed": {"tok", "unembed"}, "final_norm", "layers": {"ln1",
"ln2", "attn": {"wq", "wk", "wv", "wo"[, "bq", "bk", "bv"]}, "mlp": {"wg",
"wu", "wd"}[, "ln1_post", "ln2_post"]}[, "vis_proj"]}``, the per-layer
leaves stacked on a leading ``n_layers`` axis, as the reference's init
builds them (gemma2-2b: 14 leaves), so that ``convert.params_from_jax`` and
checkpoints carry across unchanged.

The reference scans over the stacked layers and hands each layer a traced
local/global flag; here a Python loop takes layer ``i`` as ``{k: v[i]}`` and
decides its attention window statically: the sliding window on a local
layer (``i % local_global_period == 0``), none on a global one.  Every
full-sequence layer therefore runs causal self-attention through
``attention.FlashAttention`` (the CUDA kernel ``flash_attention_fwd`` when
the activations lie on the card, the plain ``attention_ref`` on the CPU),
and decode the plain masked ``sdpa``, as the reference computes both.
``cfg.remat`` changes memory, not numbers: it is accepted and ignored.

The MoE layer, MLA, deepseek's first-k dense prefix and its MTP loss raise
``NotImplementedError``: they come with the moe slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (cross_entropy, dense_init,
                                       embed_tokens, init_embed, init_mlp,
                                       init_rms_norm, mlp_forward, rms_norm,
                                       unembed)
from repro_torch.tree import tree_map

_MOE = ("the MoE layer, MLA, the first-k dense prefix and the MTP loss "
        "come with the moe slice (models/moe.py), ROADMAP.md Queue 1, LLM "
        "side")


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.moe is not None or cfg.mla is not None or cfg.use_mtp:
        raise NotImplementedError(f"{cfg.arch_id}: {_MOE}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(generator: torch.Generator, cfg: ArchConfig) -> Dict:
    """One transformer layer, on the CPU, drawn from ``generator``."""
    p = {"ln1": init_rms_norm(cfg.d_model), "ln2": init_rms_norm(cfg.d_model),
         "attn": attn.init_attn(generator, cfg),
         "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff)}
    if cfg.post_block_norm:
        p["ln1_post"] = init_rms_norm(cfg.d_model)
        p["ln2_post"] = init_rms_norm(cfg.d_model)
    return p


def init_lm(cfg: ArchConfig, generator: torch.Generator,
            device="cuda") -> Dict:
    """Params drawn on the CPU from ``generator`` (the reference's shapes and
    init laws, not its numbers), then moved to ``device``."""
    _dense_only(cfg)
    dev = resolve_device(device)
    params: Dict = {"embed": init_embed(generator, cfg.vocab, cfg.d_model),
                    "final_norm": init_rms_norm(cfg.d_model)}
    layers = [_init_layer(generator, cfg) for _ in range(cfg.n_layers)]
    params["layers"] = tree_map(lambda *xs: torch.stack(xs), *layers)
    del layers
    if cfg.n_visual_tokens:
        params["vis_proj"] = dense_init(generator, (cfg.d_model, cfg.d_model))
    return tree_map(lambda x: x.to(dev), params)


def _is_local(cfg: ArchConfig, i: int) -> bool:
    """Whether layer ``i`` attends through the sliding window."""
    if cfg.local_global_period:
        return i % cfg.local_global_period == 0
    return bool(cfg.sliding_window)


def _window(cfg: ArchConfig, i: int) -> int:
    """Layer ``i``'s attention window: the sliding window on a local layer,
    0 (none) on a global one."""
    return cfg.sliding_window if _is_local(cfg, i) else 0


def _layer(params, i: int):
    return tree_map(lambda x: x[i], params["layers"])


def _embed(cfg: ArchConfig, params, tokens) -> torch.Tensor:
    """Token embeddings in the activation dtype; gemma's embedding scale
    ``sqrt(d_model)``, itself in that dtype, where the config has
    post-block norms."""
    dt = cfg.activation_dtype
    h = embed_tokens(params["embed"], tokens, dt)
    if cfg.post_block_norm:
        # the scale rounded to dt on the host: a tensor made on the card
        # from a host scalar would wait for the card's queue
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=dt).item()
    return h


def _post_block(cfg: ArchConfig, p, key: str, x) -> torch.Tensor:
    """gemma2's post-block RMSNorm ``p[key]`` of a block's output."""
    return rms_norm(x, p[key], cfg.norm_eps) if cfg.post_block_norm else x


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _layer_forward(cfg: ArchConfig, p, h, positions, window: int):
    """One layer; residuals added in the activation dtype, the output cast
    back to it."""
    dt = h.dtype
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    a, _ = attn.attn_forward(cfg, p["attn"], x, positions=positions,
                             window=window)
    h = h + _post_block(cfg, p, "ln1_post", a)
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    h = h + _post_block(cfg, p, "ln2_post", mlp_forward(p["mlp"], x))
    return h.to(dt)


def lm_hidden(cfg: ArchConfig, params, tokens,
              visual: Optional[torch.Tensor] = None):
    """tokens (B, S_text) [; visual (B, V, d)] -> (h (B, S, d) final-normed
    in the activation dtype, aux).  aux is the reference's auxiliary loss,
    0 for a dense FFN."""
    _dense_only(cfg)
    h = _embed(cfg, params, tokens)
    if cfg.n_visual_tokens:
        if visual is None:
            raise ValueError(f"{cfg.arch_id}: a vlm arch needs visual "
                             f"embeddings (batch['visual'])")
        dt = h.dtype
        vis = visual.to(dt) @ params["vis_proj"].to(dt)
        h = torch.cat([vis, h], dim=1)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)
    for i in range(cfg.n_layers):
        h = _layer_forward(cfg, _layer(params, i), h, positions,
                           _window(cfg, i))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, torch.zeros((), device=h.device)


def lm_logits(cfg: ArchConfig, params, tokens, visual=None):
    h, aux = lm_hidden(cfg, params, tokens, visual)
    return unembed(params["embed"], h, cfg.final_softcap), aux


def lm_loss(cfg: ArchConfig, params, batch: Dict) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S) [, visual (B, V, d)].  For a vlm
    arch the loss takes the text positions only."""
    tokens, labels = batch["tokens"], batch["labels"]
    h, _ = lm_hidden(cfg, params, tokens, batch.get("visual"))
    h_text = h[:, cfg.n_visual_tokens:, :]
    mask = (labels >= 0).float()
    logits = unembed(params["embed"], h_text, cfg.final_softcap)
    return cross_entropy(logits, torch.clamp(labels, min=0), mask)


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  device) -> Dict:
    """KV caches of every layer, stacked on a leading ``n_layers`` axis:
    ``{"layers": {"k", "v"}}``, each (n_layers, B, max_len, Hkv, hd)."""
    _dense_only(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}}


def _layer_decode(cfg: ArchConfig, p, h, lcache, pos: int, window: int):
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    a, k, v = attn.attn_decode(cfg, p["attn"], x, lcache["k"], lcache["v"],
                               pos, window=window)
    h = h + _post_block(cfg, p, "ln1_post", a)
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    h = h + _post_block(cfg, p, "ln2_post", mlp_forward(p["mlp"], x))
    return h, {"k": k, "v": v}


def lm_decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """tokens (B, 1), pos an int -> (logits (B, 1, V), new cache)."""
    _dense_only(cfg)
    h = _embed(cfg, params, tokens)
    new = []
    for i in range(cfg.n_layers):
        lcache = tree_map(lambda x: x[i], cache["layers"])
        h, nc = _layer_decode(cfg, _layer(params, i), h, lcache, pos,
                              _window(cfg, i))
        new.append(nc)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg.final_softcap)
    return logits, {"layers": tree_map(lambda *xs: torch.stack(xs), *new)}
