"""Config registry: ``get_config(arch_id)`` / ``list_archs()``, as in
``src/repro/configs/__init__.py``.

The registry holds every architecture of the reference: ``mamba2-130m``,
the hybrid ``zamba2-1.2b``, the dense and vlm families (``gemma2-2b``,
``codeqwen1.5-7b``, ``minitron-8b``, ``qwen1.5-110b``, ``internvl2-76b``),
the moe family (``granite-moe-1b-a400m``, ``deepseek-v3-671b``) and the
encdec (audio) ``whisper-large-v3``; the paper's CNNs live in
:mod:`repro_torch.configs.paper_models`.  An unknown id raises
``KeyError``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, InputShape,  # noqa: F401
                                      INPUT_SHAPES, get_shape,
                                      reduce_for_smoke)
from repro_torch.configs.codeqwen1p5_7b import CONFIG as _codeqwen
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.granite_moe_1b import CONFIG as _granite
from repro_torch.configs.internvl2_76b import CONFIG as _internvl
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.minitron_8b import CONFIG as _minitron
from repro_torch.configs.qwen1p5_110b import CONFIG as _qwen110
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.zamba2_1p2b import CONFIG as _zamba2

_REGISTRY: Dict[str, ArchConfig] = {
    c.arch_id: c for c in (_mamba2, _zamba2, _gemma2, _codeqwen, _minitron,
                           _qwen110, _internvl, _granite, _deepseek,
                           _whisper)}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in _REGISTRY:
        return _REGISTRY[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "get_config",
           "get_shape", "list_archs", "reduce_for_smoke"]
