"""SSM language model for the pure-SSM family (mamba2-130m), as in
``src/repro/models/ssm_lm.py``.

Params: ``{"embed": {"tok", "unembed"}, "final_norm", "layers": {"ln",
"mamba": {...}}}``, the per-layer leaves stacked on a leading ``n_layers``
axis (12 leaves in all).  The reference scans over the stacked layers; here a
Python loop takes layer ``i`` as ``{k: v[i]}``.  ``cfg.remat`` changes memory,
not numbers: it is accepted and ignored in this slice.

The one intended difference from the reference: ``ssm_lm_hidden`` runs the
Mamba2 scan through the kernel path (``mamba2_forward(use_kernel=True)``,
the CUDA kernel ``ssd_fwd``) when the activations lie on the card, and
through the plain ``ssd_chunked`` when they lie on the CPU.  The reference
hard-codes ``use_kernel = False`` (``src/repro/models/ssm_lm.py:73``), so on
the CPU both packages run the chunked scan and the parity tests compare like
with like.

The hybrid family (zamba2: a shared attention block every ``attn_every``
layers) raises ``NotImplementedError``: it comes with the attention slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (cross_entropy, embed_tokens,
                                       init_embed, init_rms_norm, rms_norm,
                                       unembed)
from repro_torch.tree import tree_map

_HYBRID = ("the hybrid SSM family (zamba2's shared attention block) comes "
           "with the attention slice, ROADMAP.md Queue 1 item 3")


def _pure_ssm(cfg: ArchConfig) -> None:
    if cfg.attn_every:
        raise NotImplementedError(f"{cfg.arch_id}: {_HYBRID}")


def _layer(params, i: int):
    return tree_map(lambda x: x[i], params["layers"])


def init_ssm_lm(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """Params drawn on the CPU from ``generator`` (the reference's shapes and
    init laws), then moved to ``device``."""
    _pure_ssm(cfg)
    dev = resolve_device(device)
    params: Dict = {"embed": init_embed(generator, cfg.vocab, cfg.d_model),
                    "final_norm": init_rms_norm(cfg.d_model)}
    layers = [{"ln": init_rms_norm(cfg.d_model),
               "mamba": m2.init_mamba2(generator, cfg)}
              for _ in range(cfg.n_layers)]
    params["layers"] = tree_map(lambda *xs: torch.stack(xs), *layers)
    return tree_map(lambda x: x.to(dev), params)


def ssm_lm_hidden(cfg: ArchConfig, params, tokens, *, window: int = 0):
    """Final-normed hidden states (B, S, d) in the activation dtype.
    ``window`` is the hybrid's attention window, unused by a pure SSM."""
    _pure_ssm(cfg)
    h = embed_tokens(params["embed"], tokens, cfg.activation_dtype)
    use_kernel = h.device.type == "cuda"
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x = rms_norm(h, lp["ln"], cfg.norm_eps)
        h = h + m2.mamba2_forward(cfg, lp["mamba"], x,
                                  use_kernel=use_kernel)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def ssm_lm_loss(cfg: ArchConfig, params, batch: Dict) -> torch.Tensor:
    tokens, labels = batch["tokens"], batch["labels"]
    h = ssm_lm_hidden(cfg, params, tokens, window=cfg.sliding_window)
    logits = unembed(params["embed"], h, cfg.final_softcap)
    mask = (labels >= 0).float()
    return cross_entropy(logits, torch.clamp(labels, min=0), mask)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device="cpu"):
    """Per-layer conv ring buffers and SSM states, stacked on a leading
    ``n_layers`` axis.  ``max_len`` bounds the hybrid's attention cache,
    unused by a pure SSM."""
    _pure_ssm(cfg)
    per = m2.init_ssm_cache(cfg, batch, dtype, device)
    return {"ssm": tree_map(
        lambda x: x[None].repeat((cfg.n_layers,) + (1,) * x.dim()), per)}


def ssm_lm_decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """tokens (B,1), pos -> (logits (B,1,V), new cache).  ``pos`` places the
    hybrid's attention; a pure SSM's recurrence does not read it."""
    _pure_ssm(cfg)
    h = embed_tokens(params["embed"], tokens, cfg.activation_dtype)
    new_ssm = []
    for i in range(cfg.n_layers):   # decode is unrolled: tiny per-layer work
        lp = _layer(params, i)
        lc = tree_map(lambda x: x[i], cache["ssm"])
        x = rms_norm(h, lp["ln"], cfg.norm_eps)
        out, nc = m2.mamba2_decode(cfg, lp["mamba"], x, lc)
        h = h + out
        new_ssm.append(nc)
    new_cache = {"ssm": tree_map(lambda *xs: torch.stack(xs), *new_ssm)}
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg.final_softcap)
    return logits, new_cache
