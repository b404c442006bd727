"""SSM and hybrid language models, as in ``src/repro/models/ssm_lm.py``:
mamba2-130m (pure SSD) and zamba2-1.2b (a Mamba2 backbone plus one *shared*
transformer block applied every ``attn_every`` layers to concat(hidden,
original embedding), arXiv:2411.15242; the per-invocation LoRA adapters of
the original are simplified away, as in the reference).

Params: ``{"embed": {"tok", "unembed"}, "final_norm", "layers": {"ln",
"mamba": {...}}}``, the per-layer leaves stacked on a leading ``n_layers``
axis (12 leaves), and for the hybrid ``"shared": {"ln_in", "attn": {"wq",
"wk", "wv", "wo"}, "ln_mlp", "mlp": {"wg", "wu", "wd"}}`` (21 leaves in
all).  The reference scans over the stacked layers with a ``lax.cond`` for
the shared block; here a Python loop takes layer ``i`` as ``{k: v[i]}`` and
an ``if`` applies the shared block after layers ``attn_every - 1``,
``2 attn_every - 1``, ...  ``cfg.remat`` changes memory, not numbers: it is
accepted and ignored.

The one intended difference from the reference: ``ssm_lm_hidden`` runs the
Mamba2 scan through the kernel path (``mamba2_forward(use_kernel=True)``,
the CUDA kernel ``ssd_fwd``) and the shared block's attention through
``attention.FlashAttention`` (the CUDA kernel ``flash_attention_fwd``) when
the activations lie on the card, and through the plain ``ssd_chunked`` and
``attention_ref`` when they lie on the CPU.  The reference hard-codes
``use_kernel = False`` (``src/repro/models/ssm_lm.py:73``) and calls the
plain ``sdpa``, so on the CPU both packages compute the same plain
functions and the parity tests compare like with like.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (cross_entropy, embed_tokens,
                                       init_embed, init_mlp, init_rms_norm,
                                       mlp_forward, rms_norm, unembed)
from repro_torch.tree import tree_map


def n_shared_slots(cfg: ArchConfig) -> int:
    if not cfg.attn_every:
        return 0
    return cfg.n_layers // cfg.attn_every


def _is_shared_layer(cfg: ArchConfig, i: int) -> bool:
    """Whether the shared block follows Mamba2 layer ``i``."""
    return bool(cfg.attn_every) and i % cfg.attn_every == cfg.attn_every - 1


def _layer(params, i: int):
    return tree_map(lambda x: x[i], params["layers"])


def init_ssm_lm(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """Params drawn on the CPU from ``generator`` (the reference's shapes and
    init laws), then moved to ``device``."""
    dev = resolve_device(device)
    params: Dict = {"embed": init_embed(generator, cfg.vocab, cfg.d_model),
                    "final_norm": init_rms_norm(cfg.d_model)}
    layers = [{"ln": init_rms_norm(cfg.d_model),
               "mamba": m2.init_mamba2(generator, cfg)}
              for _ in range(cfg.n_layers)]
    params["layers"] = tree_map(lambda *xs: torch.stack(xs), *layers)
    if cfg.attn_every:
        params["shared"] = {
            "ln_in": init_rms_norm(2 * cfg.d_model),
            "attn": attn.init_attn(generator, cfg, d_in=2 * cfg.d_model),
            "ln_mlp": init_rms_norm(cfg.d_model),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff),
        }
    return tree_map(lambda x: x.to(dev), params)


def _shared_block(cfg: ArchConfig, sp, h, emb0, positions, window: int):
    """Shared attention+MLP block on concat(h, emb0)."""
    u = rms_norm(torch.cat([h, emb0], dim=-1), sp["ln_in"], cfg.norm_eps)
    a, _ = attn.attn_forward(cfg, sp["attn"], u, positions=positions,
                             window=window)
    h = h + a
    x = rms_norm(h, sp["ln_mlp"], cfg.norm_eps)
    return h + mlp_forward(sp["mlp"], x)


def ssm_lm_hidden(cfg: ArchConfig, params, tokens, *, window: int = 0):
    """Final-normed hidden states (B, S, d) in the activation dtype.
    ``window`` is the hybrid's attention window (0: none)."""
    emb0 = embed_tokens(params["embed"], tokens, cfg.activation_dtype)
    h = emb0
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)
    use_kernel = h.device.type == "cuda"
    shared = params.get("shared")
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x = rms_norm(h, lp["ln"], cfg.norm_eps)
        h = h + m2.mamba2_forward(cfg, lp["mamba"], x,
                                  use_kernel=use_kernel)
        if shared is not None and _is_shared_layer(cfg, i):
            h = _shared_block(cfg, shared, h, emb0, positions, window)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def ssm_lm_loss(cfg: ArchConfig, params, batch: Dict) -> torch.Tensor:
    tokens, labels = batch["tokens"], batch["labels"]
    # the shared attention block (zamba2) uses its sliding window in
    # training too
    h = ssm_lm_hidden(cfg, params, tokens, window=cfg.sliding_window)
    logits = unembed(params["embed"], h, cfg.final_softcap)
    mask = (labels >= 0).float()
    return cross_entropy(logits, torch.clamp(labels, min=0), mask)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device):
    """Per-layer conv ring buffers and SSM states, stacked on a leading
    ``n_layers`` axis; for the hybrid, one attention KV ring per shared
    slot holding ``T = min(max_len, sliding_window)`` positions (the whole
    ``max_len`` without a window), and ``emb0: None`` (the decode step
    embeds the current token itself)."""
    per = m2.init_ssm_cache(cfg, batch, dtype, device)
    cache = {"ssm": tree_map(
        lambda x: x[None].repeat((cfg.n_layers,) + (1,) * x.dim()), per)}
    slots = n_shared_slots(cfg)
    if slots:
        hd = cfg.resolved_head_dim
        T = min(max_len, cfg.sliding_window) if cfg.sliding_window \
            else max_len
        shape = (slots, batch, T, cfg.n_kv_heads, hd)
        cache["attn"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}
        cache["emb0"] = None
    return cache


def _set_slot(stack, slot: int, value):
    """``stack`` with ``stack[slot]`` replaced, functionally (decode runs
    under ``torch.func.vmap``)."""
    return torch.cat([stack[:slot], value[None], stack[slot + 1:]])


def ssm_lm_decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """tokens (B,1), pos an int -> (logits (B,1,V), new cache).

    The shared attention block's KV cache is a ring buffer of the sliding
    window: the step writes slot ``pos % T``; once the ring has wrapped every
    entry is live, so the mask position is ``min(pos, T - 1)``, while the
    rotary position stays the absolute ``pos`` (as in the train path).
    """
    emb0 = embed_tokens(params["embed"], tokens, cfg.activation_dtype)
    h = emb0
    shared = params.get("shared")
    ac = cache.get("attn")

    def shared_decode(hh, ac, slot):
        u = rms_norm(torch.cat([hh, emb0], dim=-1), shared["ln_in"],
                     cfg.norm_eps)
        T = ac["k"].shape[2]
        a, kc, vc = attn.attn_decode(
            cfg, shared["attn"], u, ac["k"][slot], ac["v"][slot], pos % T,
            window=0, rope=True, rope_pos=pos, mask_pos=min(pos, T - 1))
        ac = {"k": _set_slot(ac["k"], slot, kc),
              "v": _set_slot(ac["v"], slot, vc)}
        hh = hh + a
        x = rms_norm(hh, shared["ln_mlp"], cfg.norm_eps)
        return hh + mlp_forward(shared["mlp"], x), ac

    new_ssm = []
    for i in range(cfg.n_layers):   # decode is unrolled: tiny per-layer work
        lp = _layer(params, i)
        lc = tree_map(lambda x: x[i], cache["ssm"])
        x = rms_norm(h, lp["ln"], cfg.norm_eps)
        out, nc = m2.mamba2_decode(cfg, lp["mamba"], x, lc)
        h = h + out
        new_ssm.append(nc)
        if shared is not None and _is_shared_layer(cfg, i):
            h, ac = shared_decode(h, ac, i // cfg.attn_every)
    new_cache = {"ssm": tree_map(lambda *xs: torch.stack(xs), *new_ssm)}
    if ac is not None:
        new_cache["attn"] = ac
        new_cache["emb0"] = None
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg.final_softcap)
    return logits, new_cache
