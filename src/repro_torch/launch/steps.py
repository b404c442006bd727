"""Step functions, as in ``src/repro/launch/steps.py``: the prefill and the
one-token serve step.

The reference's train steps (``microbatched``, ``make_train_step``,
``make_cohort_train_step``) come with the training slice (ROADMAP.md Queue 1,
LLM side).  PyTorch runs eagerly, so a step is the plain function the reference
hands to ``jit``.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch):
        return api.prefill_logits(cfg, params, batch)

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """One-token decode with the KV/SSM cache (decode_32k / long_500k)."""
    def serve_step(params, cache, tokens, pos):
        return api.decode_step(cfg, params, cache, tokens, pos)

    return serve_step
