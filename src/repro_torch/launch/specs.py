"""Input and parameter specs for every (arch × input-shape) pair, as in
``src/repro/launch/specs.py``.

The reference returns ``jax.ShapeDtypeStruct`` stand-ins; here each spec is a
tensor on the ``meta`` device, which carries a shape and a dtype and no
storage, so nothing is allocated: even deepseek-v3-671b's and
qwen1.5-110b's whole parameter trees are described on any host.  The
modality carve-outs live here: VLM shapes reserve ``n_visual_tokens``
positions for stubbed patch embeddings; audio shapes carry stubbed frame
embeddings of the fixed encoder length.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import api
from repro_torch.tree import tree_map

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, shape: InputShape) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    act = cfg.activation_dtype
    batch: Dict = {}
    if cfg.n_visual_tokens:
        text = S - cfg.n_visual_tokens
        batch["tokens"] = _spec((B, text), torch.int32)
        batch["labels"] = _spec((B, text), torch.int32)
        batch["visual"] = _spec((B, cfg.n_visual_tokens, cfg.d_model), act)
    else:
        batch["tokens"] = _spec((B, S), torch.int32)
        batch["labels"] = _spec((B, S), torch.int32)
    if cfg.is_encdec:
        batch["frames"] = _spec((B, cfg.enc_len, cfg.d_model), act)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: InputShape) -> Dict:
    specs = train_batch_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_specs(cfg: ArchConfig, shape: InputShape, params_struct):
    """-> (cache_struct, tokens_struct, pos_struct).  The cache is built on
    the meta device by the model's own ``init_cache`` (an encdec arch runs
    its encoder there, which computes shapes only)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _spec((B, 1), torch.int32)}
    if cfg.is_encdec:
        batch["frames"] = _spec((B, cfg.enc_len, cfg.d_model),
                                cfg.activation_dtype)
    with torch.no_grad():
        cache = api.init_cache(cfg, params_struct, batch, S,
                               cfg.activation_dtype)
    return cache, _spec((B, 1), torch.int32), _spec((), torch.int32)


def params_struct(cfg: ArchConfig, cast: bool = True):
    """Abstract parameter tree (the init's own shapes, drawn on the meta
    device, where a draw is a no-op); with ``cast``, ≥2-D leaves in
    ``cfg.dtype`` (bf16 in production) and 1-D norm/scale vectors f32."""
    with torch.device(META):
        struct = api.init_params(cfg, torch.Generator(), META)
    return cast_params(cfg, struct) if cast else struct


def cast_params(cfg: ArchConfig, params):
    """Concrete counterpart of params_struct's dtype policy."""
    act = cfg.activation_dtype
    return tree_map(lambda leaf: leaf.to(act) if leaf.dim() >= 2 else leaf,
                    params)
