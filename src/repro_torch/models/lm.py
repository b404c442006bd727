"""Decoder-only LM of the dense, moe and vlm families, as in
``src/repro/models/lm.py``: GQA with optional QKV bias (qwen), logit softcaps,
post-block norms, the embedding scale and local/global alternation
(gemma2), MLA (deepseek-v3), a dense SwiGLU FFN or the MoE layer of
:mod:`repro_torch.models.moe` (routed and shared experts), deepseek's
first-k dense prefix and its MTP loss, and the vlm family's stubbed visual
prefix (precomputed patch embeddings through ``vis_proj``, prepended to the
text stream; the ViT is not implemented, as in the reference).

Params: ``{"embed": {"tok", "unembed"}, "final_norm", "layers": {"ln1",
"ln2", "attn": {"wq", "wk", "wv", "wo"[, "bq", "bk", "bv"]} or MLA's
{"w_dq", "w_uq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"}, "mlp": {"wg",
"wu", "wd"} or "moe": {"router", "wg", "wu", "wd"[, "shared"]}[,
"ln1_post", "ln2_post"]}[, "dense_prefix": [layer, ...]][, "mtp": {"proj",
"block", "norm"}][, "vis_proj"]}``.  The layers after the dense prefix are
stacked on a leading axis and the prefix is a list of unstacked layers, as
the reference's init builds them (gemma2-2b: 14 leaves, granite-moe: 13,
deepseek-v3: 45 at any depth), so that ``convert.params_from_jax`` and
checkpoints carry across unchanged.

The reference scans over the stacked layers and hands each layer a traced
local/global flag; here a Python loop takes layer ``i`` as ``{k: v[i]}`` and
decides its attention window statically: the sliding window on a local
layer (``i % local_global_period == 0``, ``i`` counted from the first
layer, the dense prefix included), none on a global one or in the prefix.
Every full-sequence GQA layer therefore runs causal self-attention through
``attention.FlashAttention`` (the CUDA kernel ``flash_attention_fwd`` when
the activations lie on the card, the plain ``attention_ref`` on the CPU),
and decode the plain masked ``sdpa``, as the reference computes both; MLA
runs plain in both.  The MTP block runs in ``lm_loss`` only.  ``cfg.remat``
changes memory, not numbers: it is accepted and ignored.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (cross_entropy, dense_init,
                                       embed_tokens, init_embed, init_mlp,
                                       init_rms_norm, mlp_forward, rms_norm,
                                       unembed)
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(generator: torch.Generator, cfg: ArchConfig, *,
                dense_ffn_width: int = 0) -> Dict:
    """One transformer layer, on the CPU, drawn from ``generator``;
    ``dense_ffn_width`` gives it a dense FFN of that width in place of the
    MoE (deepseek's prefix and MTP block)."""
    p = {"ln1": init_rms_norm(cfg.d_model), "ln2": init_rms_norm(cfg.d_model),
         "attn": (attn.init_mla(generator, cfg) if cfg.mla is not None
                  else attn.init_attn(generator, cfg))}
    if dense_ffn_width:
        p["mlp"] = init_mlp(generator, cfg.d_model, dense_ffn_width)
    elif cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(generator, cfg)
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff)
    if cfg.post_block_norm:
        p["ln1_post"] = init_rms_norm(cfg.d_model)
        p["ln2_post"] = init_rms_norm(cfg.d_model)
    return p


def _first_k(cfg: ArchConfig) -> int:
    """Layers of the dense prefix (deepseek-v3's first-k dense layers)."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def n_scanned_layers(cfg: ArchConfig) -> int:
    """Layers stacked under ``params["layers"]``: all but the prefix."""
    return cfg.n_layers - _first_k(cfg)


def init_lm(cfg: ArchConfig, generator: torch.Generator,
            device="cuda") -> Dict:
    """Params drawn on the CPU from ``generator`` (the reference's shapes and
    init laws, not its numbers), then moved to ``device``."""
    dev = resolve_device(device)
    params: Dict = {"embed": init_embed(generator, cfg.vocab, cfg.d_model),
                    "final_norm": init_rms_norm(cfg.d_model)}
    if _first_k(cfg):
        params["dense_prefix"] = [
            _init_layer(generator, cfg, dense_ffn_width=cfg.moe.dense_d_ff)
            for _ in range(_first_k(cfg))]
    layers = [_init_layer(generator, cfg)
              for _ in range(n_scanned_layers(cfg))]
    params["layers"] = tree_map(lambda *xs: torch.stack(xs), *layers)
    del layers
    if cfg.n_visual_tokens:
        params["vis_proj"] = dense_init(generator, (cfg.d_model, cfg.d_model))
    if cfg.use_mtp:
        params["mtp"] = {
            "proj": dense_init(generator, (2 * cfg.d_model, cfg.d_model)),
            "block": _init_layer(generator, cfg,
                                 dense_ffn_width=cfg.d_ff or 2048),
            "norm": init_rms_norm(cfg.d_model)}
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


def _layers(cfg: ArchConfig, params):
    """(the dense prefix, the stacked layers), each a list of (layer
    params, attention window).  The prefix attends without a window, as
    the reference's local flag False gives it; the stacked layers' local
    flags count from the first layer, the prefix included."""
    prefix = params.get("dense_prefix", [])
    stacked = [(_layer(params, i), _window(cfg, len(prefix) + i))
               for i in range(n_scanned_layers(cfg))]
    return [(p, 0) for p in prefix], stacked


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
    """One layer -> (h, aux): residuals added in the activation dtype, the
    output cast back to it; aux is the MoE's load-balance loss, None for a
    dense FFN."""
    dt = h.dtype
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, _ = attn.mla_forward(cfg, p["attn"], x, positions=positions)
    else:
        a, _ = attn.attn_forward(cfg, p["attn"], x, positions=positions,
                                 window=window)
    h = h + _post_block(cfg, p, "ln1_post", a)
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    aux = None
    if "moe" in p:
        f, aux = moe_mod.moe_forward(cfg, p["moe"], x)
    else:
        f = mlp_forward(p["mlp"], x)
    h = h + _post_block(cfg, p, "ln2_post", f)
    return h.to(dt), aux


def lm_hidden(cfg: ArchConfig, params, tokens,
              visual: Optional[torch.Tensor] = None):
    """tokens (B, S_text) [; visual (B, V, d)] -> (h (B, S, d) final-normed
    in the activation dtype, aux).  aux is the sum of the MoE layers'
    load-balance losses, 0 without MoE layers."""
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
    aux = torch.zeros((), device=h.device)
    prefix, stacked = _layers(cfg, params)
    for p, window in prefix + stacked:
        h, a = _layer_forward(cfg, p, h, positions, window)
        if a is not None:
            aux = aux + a
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, aux


def lm_logits(cfg: ArchConfig, params, tokens, visual=None):
    h, aux = lm_hidden(cfg, params, tokens, visual)
    return unembed(params["embed"], h, cfg.final_softcap), aux


def lm_loss(cfg: ArchConfig, params, batch: Dict) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S) [, visual (B, V, d)].  For a vlm
    arch the loss takes the text positions only.  Adds the MoE's aux loss
    and, for deepseek, 0.1 x the MTP loss."""
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux = lm_hidden(cfg, params, tokens, batch.get("visual"))
    h_text = h[:, cfg.n_visual_tokens:, :]
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0)
    logits = unembed(params["embed"], h_text, cfg.final_softcap)
    loss = cross_entropy(logits, labels, mask)
    if cfg.use_mtp and "mtp" in params:
        loss = loss + 0.1 * _mtp_loss(cfg, params, h_text, tokens, labels,
                                      mask)
    return loss + aux


def _mtp_loss(cfg: ArchConfig, params, h, tokens, labels, mask):
    """DeepSeek-V3 multi-token prediction: token t+2 from concat(h_t,
    embed(token_{t+1})) through one extra block (a dense FFN of width
    ``d_ff``), sharing the unembedding.  ``labels`` are the clamped labels
    and ``mask`` the unshifted one, as the reference passes them."""
    mp = params["mtp"]
    dt = h.dtype
    B, S = tokens.shape
    # next-token embeddings, shifted left by one
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    e = embed_tokens(params["embed"], nxt, dt)
    hcat = torch.cat([h, e], dim=-1) @ mp["proj"].to(dt)
    positions = torch.arange(S, device=h.device).expand(B, S)
    hm, _ = _layer_forward(cfg, mp["block"], hcat, positions, 0)
    hm = rms_norm(hm, mp["norm"], cfg.norm_eps)
    logits = unembed(params["embed"], hm, cfg.final_softcap)
    # target: token t+2, the labels shifted left by one, the last masked
    lab2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)],
                     dim=1)
    m2 = mask * (lab2 >= 0).float()
    return cross_entropy(logits, torch.clamp(lab2, min=0), m2)


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  device) -> Dict:
    """Caches of every layer, stacked on a leading layer axis: ``{"layers":
    ...[, "dense_prefix": ...]}``, each GQA cache ``{"k", "v"}`` of (n, B,
    max_len, Hkv, hd), each MLA cache ``{"ckv", "krope"}`` of (n, B,
    max_len, kv_lora) and (n, B, max_len, rope)."""
    def one(n):
        if cfg.mla is not None:
            m = cfg.mla
            shapes = {"ckv": (n, batch, max_len, m.kv_lora_rank),
                      "krope": (n, batch, max_len, m.qk_rope_head_dim)}
        else:
            kv = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            shapes = {"k": kv, "v": kv}
        return {k: torch.zeros(sh, dtype=dtype, device=device)
                for k, sh in shapes.items()}
    cache = {"layers": one(n_scanned_layers(cfg))}
    if _first_k(cfg):
        cache["dense_prefix"] = one(_first_k(cfg))
    return cache


def _layer_decode(cfg: ArchConfig, p, h, lcache, pos: int, window: int):
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, ckv, krope = attn.mla_decode(cfg, p["attn"], x, lcache["ckv"],
                                        lcache["krope"], pos)
        new = {"ckv": ckv, "krope": krope}
    else:
        a, k, v = attn.attn_decode(cfg, p["attn"], x, lcache["k"],
                                   lcache["v"], pos, window=window)
        new = {"k": k, "v": v}
    h = h + _post_block(cfg, p, "ln1_post", a)
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, _ = moe_mod.moe_forward(cfg, p["moe"], x)
    else:
        f = mlp_forward(p["mlp"], x)
    h = h + _post_block(cfg, p, "ln2_post", f)
    return h, new


def _decode_layers(cfg: ArchConfig, layers, caches, h, pos: int):
    """``layers`` [(params, window)] over their stacked ``caches`` ->
    (h, the new stacked caches)."""
    new = []
    for i, (p, window) in enumerate(layers):
        h, nc = _layer_decode(cfg, p, h, tree_map(lambda x: x[i], caches),
                              pos, window)
        new.append(nc)
    return h, tree_map(lambda *xs: torch.stack(xs), *new)


def lm_decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """tokens (B, 1), pos an int -> (logits (B, 1, V), new cache)."""
    h = _embed(cfg, params, tokens)
    prefix, stacked = _layers(cfg, params)
    new = {}
    if prefix:
        h, new["dense_prefix"] = _decode_layers(cfg, prefix,
                                                cache["dense_prefix"], h, pos)
    h, new["layers"] = _decode_layers(cfg, stacked, cache["layers"], h, pos)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg.final_softcap)
    return logits, new
