"""Front for the flash-attention kernel, as in
``src/repro/kernels/flash_attention/ops.py``.

``mode`` picks the implementation:

  * ``"auto"``   -- the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors and for meta tensors (shapes only, ``launch/specs.py``) (the
    reference's "auto" runs the Pallas kernel on its accelerator and the
    plain version elsewhere);
  * ``"kernel"`` -- the CUDA kernel (which raises on a CPU tensor);
  * ``"ref"``    -- the plain version on any device.

No ``try`` falls back from one to the other.  The reference's ``block_q`` /
``block_k`` are the TPU kernel's tile sizes; the CUDA kernels' tiles are
fixed by dtype and head dim (``kernel.key_tile``), so the port has no such
arguments.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import attention_ref

_MODES = ("auto", "kernel", "ref")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, mode: str = "auto") -> torch.Tensor:
    """q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd) -> (B,S,Hq,hd) in q's dtype; query
    row i sits at position i (causal with T != S is offset 0, as the TPU
    kernel's).  The kernel path hands the kernel contiguous q, k and v."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if mode == "ref" or (mode == "auto" and q.device.type != "cuda"):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    return K.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal,
                                 window=window, softcap=softcap)
