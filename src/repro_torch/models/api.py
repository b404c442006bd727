"""Unified model API, as in ``src/repro/models/api.py``: family dispatch used
by PersA-FL core, the launch layer and the tests.

    init_params(cfg, generator, device)    -> params tree
    loss_fn(cfg, params, batch)            -> scalar loss  (the f_i of Eq. 2)
    prefill_logits(cfg, params, batch)     -> last-position logits (B, V)
    init_cache(cfg, params, batch, ...)    -> decode cache
    decode_step(cfg, params, cache, tokens, pos) -> (logits, cache)

Every family of the reference: the pure-SSM (mamba2-130m) and hybrid
(zamba2-1.2b) families through :mod:`repro_torch.models.ssm_lm`, the encdec
(audio) family (whisper-large-v3) through :mod:`repro_torch.models.encdec`,
and the dense, vlm and moe families (gemma2-2b, codeqwen1.5-7b,
minitron-8b, qwen1.5-110b, internvl2-76b, granite-moe-1b-a400m,
deepseek-v3-671b) through :mod:`repro_torch.models.lm`, dispatched as the
reference dispatches them.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as ed
from repro_torch.models import lm, ssm_lm
from repro_torch.models.layers import unembed


def _is_ssm(cfg: ArchConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    if _is_ssm(cfg):
        return ssm_lm.init_ssm_lm(cfg, generator, device)
    if cfg.is_encdec:
        return ed.init_encdec(cfg, generator, device)
    return lm.init_lm(cfg, generator, device)


def loss_fn(cfg: ArchConfig, params, batch: Dict) -> torch.Tensor:
    """The client loss f_i(w; D_i) -- Eq. (2) of the paper, per arch."""
    if _is_ssm(cfg):
        return ssm_lm.ssm_lm_loss(cfg, params, batch)
    if cfg.is_encdec:
        return ed.encdec_loss(cfg, params, batch)
    return lm.lm_loss(cfg, params, batch)


def prefill_logits(cfg: ArchConfig, params, batch: Dict) -> torch.Tensor:
    """Inference-prefill: full forward, last-position logits (B, V); an
    encdec arch encodes ``batch["frames"]`` first."""
    if _is_ssm(cfg):
        h = ssm_lm.ssm_lm_hidden(cfg, params, batch["tokens"],
                                 window=cfg.sliding_window)
    elif cfg.is_encdec:
        enc_h = ed.encode(cfg, params, batch["frames"])
        h = ed.decode_full(cfg, params, batch["tokens"], enc_h)
    else:
        h, _ = lm.lm_hidden(cfg, params, batch["tokens"],
                            batch.get("visual"))
    return unembed(params["embed"], h[:, -1:, :], cfg.final_softcap)[:, 0]


def init_cache(cfg: ArchConfig, params, batch: Dict, max_len: int, dtype):
    """Decode cache on the device of ``batch["tokens"]``; an encdec arch
    runs the encoder on ``batch["frames"]``."""
    tokens = batch["tokens"]
    if _is_ssm(cfg):
        return ssm_lm.init_ssm_cache(cfg, tokens.shape[0], max_len, dtype,
                                     tokens.device)
    if cfg.is_encdec:
        return ed.init_encdec_cache(cfg, params, batch["frames"], max_len,
                                    dtype)
    return lm.init_lm_cache(cfg, tokens.shape[0], max_len, dtype,
                            tokens.device)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    if _is_ssm(cfg):
        return ssm_lm.ssm_lm_decode_step(cfg, params, cache, tokens, pos)
    if cfg.is_encdec:
        return ed.encdec_decode_step(cfg, params, cache, tokens, pos)
    return lm.lm_decode_step(cfg, params, cache, tokens, pos)
