"""Carry params across from the JAX package as numpy arrays, and back.

``params_from_jax`` takes the tree ``jax.tree.map(np.asarray, params)`` gives
and returns the same tree of tensors on ``device``, dtypes kept.  bf16 arrays
arrive with numpy dtype ``bfloat16`` (registered by ``ml_dtypes``); they are
moved as their raw 16 bits, so this module never imports ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def to_tensor(x, device) -> torch.Tensor:
    """One leaf as a tensor on ``device`` (a copy; bf16 numpy arrays by their
    bits)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device="cuda"):
    """A tree of numpy arrays (from the JAX package) as tensors on
    ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: to_tensor(x, dev), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError:
            raise TypeError(
                "numpy has no bfloat16 dtype in this process (ml_dtypes "
                "registers it); convert the tensor to float32 first") from None
        return t.view(torch.int16).numpy().view(np.uint16).view(bf16)
    return t.numpy()


def params_to_numpy(tree):
    """A tree of tensors as numpy arrays on the host, dtypes kept."""
    return tree_map(_to_numpy, tree)
