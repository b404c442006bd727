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


def _bf16_sides(v: torch.Tensor, split: bool) -> torch.Tensor:
    """An f32 operand as the kernels hand it to a bf16 product: hi + lo
    (each a bf16 value; their sum is exact in f32), or hi alone."""
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float() if split else hi


def ssd_phases_ref(x, dt, a_log, B_mat, C_mat, *, chunk: int = 128,
                   split: bool = True) -> torch.Tensor:
    """The arithmetic of the CUDA kernels (``csrc/ssd.cu``) in plain
    PyTorch, phase by phase: the chunks' end states, the state pass, the
    chunk scan.  For bf16 x/B/C every f32 factor of a product goes through
    the kernels' hi/lo bf16 split (x w dt of the end states, S' = C.B^T o L
    o dt of the scan, the entering state); ``split=False`` keeps only the hi
    half, one bf16 rounding, as bf16 SSD kernels elsewhere do.  f32 inputs
    are not rounded.  No main path calls it: it models the kernels on the
    CPU, and the card holds them to it.  Shapes as :func:`ssd_ref`;
    ``chunk`` is cut to S."""
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    chunk = min(chunk, S)
    nc, rep = S // chunk, H // G
    if S % chunk:
        raise ValueError(f"ssd_phases_ref: chunk {chunk} does not divide "
                         f"S = {S}")
    bf16 = x.dtype == torch.bfloat16

    def side(v):
        return _bf16_sides(v, split) if bf16 else v

    xs = x.float().reshape(Bb, nc, chunk, H, P)
    dts = dt.float().reshape(Bb, nc, chunk, H)
    Bg = B_mat.float().reshape(Bb, nc, chunk, G, N)
    Cg = C_mat.float().reshape(Bb, nc, chunk, G, N)
    Bh = Bg.repeat_interleave(rep, dim=3)                    # (B,nc,l,H,N)
    Ch = Cg.repeat_interleave(rep, dim=3)
    A = -torch.exp(a_log.float())
    A = A[:, None, None, :] if A.dim() == 2 else A           # (B|.,1,1,H)
    a_cum = torch.cumsum(dts * A, dim=2)                     # (B,nc,l,H)

    # 1. each chunk's own end state: (x w dt)^T . B, w = exp(a_end - a_cum)
    w = torch.exp(a_cum[:, :, -1:, :] - a_cum) * dts
    xw = side(xs * w[..., None])
    ends = torch.einsum("bclhp,bclhn->bchpn", xw, Bh)
    decay = torch.exp(a_cum[:, :, -1, :])                    # (B,nc,H)

    # 2. the state entering each chunk
    run = torch.zeros_like(ends[:, 0])
    entering = []
    for c in range(nc):
        entering.append(run)
        run = decay[:, c, :, None, None] * run + ends[:, c]
    st_in = torch.stack(entering, dim=1)                     # (B,nc,H,P,N)

    # 3. the chunk scan: C.B^T per group (exact for bf16 inputs), S' masked
    #    by a select before exp, then S'.x + exp(a_cum[t]) C.state^T
    cb = torch.einsum("bctgn,bcsgn->bctsg", Cg, Bg)
    cb = cb.repeat_interleave(rep, dim=4)                    # (B,nc,t,s,H)
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=x.device).tril()[:, :, None]
    seg = torch.where(tri, seg, torch.full_like(seg, -torch.inf))
    sp = side(cb * torch.exp(seg) * dts[:, :, None, :, :])
    y = torch.einsum("bctsh,bcshp->bcthp", sp, xs)
    y = y + torch.exp(a_cum)[..., None] * torch.einsum(
        "bcthn,bchpn->bcthp", Ch, side(st_in))
    return y.reshape(Bb, S, H, P)
