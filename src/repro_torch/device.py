"""Device resolution for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fallback."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and no GPU is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch: device={str(device)!r} needs a CUDA GPU and "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"on the CPU")
    return dev
