"""Front for the SSD kernel, as in ``src/repro/kernels/ssd/ops.py``.

``mode`` picks the implementation:

  * ``"auto"``   -- the CUDA kernel for CUDA tensors, the sequential plain
    version for CPU tensors and for meta tensors (shapes only) (the
    reference's "auto" runs the Pallas kernel on its accelerator and the
    plain version elsewhere);
  * ``"kernel"`` -- the CUDA kernel (which raises on a CPU tensor);
  * ``"ref"``    -- the sequential-recurrence oracle on any device.

No ``try`` falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd.ref import ssd_ref

_MODES = ("auto", "kernel", "ref")


def ssd(x, dt, a_log, B_mat, C_mat, *, chunk: int = 128,
        mode: str = "auto") -> torch.Tensor:
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,) or (B,H); B/C: (B,S,G,N) ->
    y (B,S,H,P) f32.  The kernel path hands it contiguous f32 dt and a_log
    and x/B/C in their dtype (made contiguous)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if mode == "ref" or (mode == "auto" and x.device.type != "cuda"):
        return ssd_ref(x, dt, a_log, B_mat, C_mat)
    return K.ssd_fwd(x.contiguous(), dt.float().contiguous(),
                     a_log.float().contiguous(), B_mat.contiguous(),
                     C_mat.contiguous(), chunk=chunk)
