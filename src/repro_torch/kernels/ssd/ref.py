"""Plain PyTorch oracle for the SSD (Mamba2) kernel, as in
``src/repro/kernels/ssd/ref.py``: the sequential recurrence, the ground truth
that the chunked reference and the CUDA kernel must match.

y_t = C_t · h_t (the D skip is the caller's),
h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t.

``a_log`` is ``(H,)`` as in the reference, or ``(B, H)``: one row per batch
row, which the port's vmap rule needs when every user carries their own
params (``repro_torch.models.mamba2``).
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, a_log, B_mat, C_mat) -> torch.Tensor:
    """x: (B,S,H,P); dt: (B,S,H) post-softplus; a_log: (H,) or (B,H);
    B_mat/C_mat: (B,S,G,N) -> y (B,S,H,P) in f32."""
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    x = x.float()
    dt = dt.float()
    Bm = B_mat.float().repeat_interleave(rep, dim=2)        # (B,S,H,N)
    Cm = C_mat.float().repeat_interleave(rep, dim=2)
    A = -torch.exp(a_log.float())
    A = A[:, None, :] if A.dim() == 2 else A                # (B|1,1|.,H)
    da = torch.exp(dt * A)                                  # (B,S,H)
    x_dt = x * dt[..., None]                                # (B,S,H,P)
    h = x.new_zeros((Bb, H, P, N))
    ys = []
    for t in range(S):
        h = h * da[:, t, :, None, None] \
            + x_dt[:, t, :, :, None] * Bm[:, t, :, None, :]
        ys.append((h * Cm[:, t, :, None, :]).sum(-1))
    return torch.stack(ys, dim=1)                           # (B,S,H,P)
