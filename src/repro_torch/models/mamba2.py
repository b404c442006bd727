"""Mamba2 (SSD -- state-space duality, arXiv:2405.21060) layer, as in
``src/repro/models/mamba2.py``.

The full-sequence path is the chunked SSD algorithm: a quadratic
attention-like intra-chunk term plus a linear inter-chunk recurrence (a
Python loop over chunks where the reference scans).  ``ssd_chunked`` is the
plain PyTorch version; ``mamba2_forward(use_kernel=True)`` goes through
:class:`SSDScan` instead, whose forward is ``kernels.ssd.ops.ssd`` (the
hand-written CUDA kernel ``ssd_fwd`` for CUDA tensors, the sequential oracle
for CPU tensors).

Decode is the O(1)-per-token recurrence with a conv ring buffer.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import dense_init, init_rms_norm, rms_norm


def dims(cfg: ArchConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.state_dim
    return d_inner, n_heads, conv_dim


def init_mamba2(generator: torch.Generator, cfg: ArchConfig):
    """One layer's params on the CPU, drawn from ``generator`` (the
    reference's shapes and init laws, not its numbers)."""
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = dims(cfg)
    proj_out = 2 * d_inner + 2 * s.n_groups * s.state_dim + n_heads
    return {
        "in_proj": dense_init(generator, (d, proj_out)),
        "conv_w": dense_init(generator, (s.conv_width, conv_dim), scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          dtype=torch.float32)),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32),
        "gate_norm": init_rms_norm(d_inner),
        "out_proj": dense_init(generator, (d_inner, d)),
    }


def _split_proj(cfg: ArchConfig, proj):
    s = cfg.ssm
    d_inner, n_heads, _ = dims(cfg)
    gn = s.n_groups * s.state_dim
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * gn, n_heads],
                             dim=-1)
    return z, xbc, dt  # dt: (..., n_heads)


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv, width W.  xbc: (B,S,Cdim); conv_w: (W,Cdim)."""
    W = conv_w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i: i + S, :] * conv_w[i].to(xbc.dtype)
              for i in range(W))
    return F.silu(out + conv_b.to(xbc.dtype))


def ssd_chunked(x, dt, a_log, B_mat, C_mat, chunk: int):
    """Chunked SSD scan (plain PyTorch; f32 internals).

    x: (B,S,H,P); dt: (B,S,H) (post-softplus); a_log: (H,) or (B,H)
    (A = −exp(a_log)); B_mat/C_mat: (B,S,G,N) with H % G == 0.
    Returns y: (B,S,H,P) f32.
    """
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S = {S} is not a multiple of chunk "
                         f"= {chunk}")
    nc, rep = S // chunk, H // G

    x = x.float().reshape(Bb, nc, chunk, H, P)
    dt = dt.float().reshape(Bb, nc, chunk, H)
    Bm = B_mat.float().repeat_interleave(rep, dim=2).reshape(
        Bb, nc, chunk, H, N)
    Cm = C_mat.float().repeat_interleave(rep, dim=2).reshape(
        Bb, nc, chunk, H, N)

    A = -torch.exp(a_log.float())                # (H,) or (B,H) negative
    if A.dim() == 2:
        A = A[:, None, None, :]
    a = dt * A                                   # (B,nc,l,H) log-decay
    a_cum = torch.cumsum(a, dim=2)               # inclusive, within chunk
    x_dt = x * dt[..., None]

    # intra-chunk (quadratic, attention-like): L[l,s] = exp(acum_l − acum_s)
    # for l ≥ s
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B,nc,l,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=seg.device))
    # mask BEFORE exp: upper-triangular seg is positive and exp overflows,
    # poisoning gradients through the where
    seg = torch.where(tri[None, None, :, :, None], seg,
                      torch.full_like(seg, float("-inf")))
    L = torch.exp(seg)
    y_diag = torch.einsum("bclhn,bcshn,bclsh,bcshp->bclhp", Cm, Bm, L, x_dt)

    # per-chunk terminal states
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)    # (B,nc,l,H)
    chunk_states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bm, decay_to_end,
                                x_dt)
    chunk_decay = torch.exp(a.sum(dim=2))                    # (B,nc,H)

    state = x.new_zeros((Bb, H, P, N))
    prev = []
    for c in range(nc):                      # emit the state *before* chunk
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,H,P,N)

    # inter-chunk contribution
    decay_from_start = torch.exp(a_cum)                      # (B,nc,l,H)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cm, prev_states,
                         decay_from_start)
    return (y_diag + y_off).reshape(Bb, S, H, P)


class SSDScan(torch.autograd.Function):
    """The SSD scan through ``kernels.ssd.ops.ssd`` with the gradient of
    :func:`ssd_chunked`.

    * forward: ``ssd_ops.ssd(..., mode="auto")`` -- the CUDA kernel
      ``ssd_fwd`` for CUDA tensors, the sequential oracle for CPU tensors;
    * backward: the vjp of :func:`ssd_chunked` on the saved inputs, which is
      what the reference differentiates (it has no backward kernel).  The
      forward is recomputed in plain PyTorch: that is the price of having no
      backward kernel (ROADMAP follow-up);
    * vmap: folds the vmapped dim into the batch dim and calls the Function
      once, so ``vmap(grad(loss))`` over a cohort launches the kernel once per
      layer and forward evaluation, whatever the cohort size.  A vmapped
      ``a_log`` (every user's own params) goes in as one row per batch row,
      ``(rows, H)``.  The rule does not look at the device, so the CPU tests
      exercise it through the plain forward.

    * jvp: the jvp of :func:`ssd_chunked` on the saved inputs, so that
      Option B's exact Hessian-vector product (``maml_mode="full"``,
      ``torch.func.jvp`` of ``torch.func.grad``) runs forward mode through
      the kernel's forward and the plain backward, as the reference, which
      differentiates ``ssd_chunked`` in either mode.  It composes with the
      vmap rule.  mamba2-130m's and zamba2-1.2b's configs use
      ``maml_mode="hf"``, which needs gradients only.
    """

    @staticmethod
    def forward(x, dt, a_log, B_mat, C_mat, chunk):
        return ssd_ops.ssd(x, dt, a_log, B_mat, C_mat, chunk=chunk,
                           mode="auto")

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, a_log, B_mat, C_mat, chunk = inputs
        ctx.save_for_backward(x, dt, a_log, B_mat, C_mat)
        ctx.save_for_forward(x, dt, a_log, B_mat, C_mat)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, gy):
        chunk = ctx.chunk
        _, vjp_fn = torch.func.vjp(
            lambda *a: ssd_chunked(*a, chunk=chunk), *ctx.saved_tensors)
        return (*vjp_fn(gy), None)

    @staticmethod
    def jvp(ctx, tx, tdt, ta, tb, tc, _):
        chunk = ctx.chunk
        primals = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, (tx, tdt, ta, tb, tc)))
        return torch.func.jvp(lambda *a: ssd_chunked(*a, chunk=chunk),
                              primals, tangents)[1]

    @staticmethod
    def vmap(info, in_dims, x, dt, a_log, B_mat, C_mat, chunk):
        V = info.batch_size

        def fold(t, d):
            # (V, rows, ...) -> (V * rows, ...), broadcasting an unbatched
            # input over the vmapped dim
            t = t.movedim(d, 0) if d is not None \
                else t.expand(V, *t.shape)
            return t.reshape(V * t.shape[1], *t.shape[2:])

        xf = fold(x, in_dims[0])
        rows = xf.shape[0] // V
        ad = in_dims[2]
        if ad is None and a_log.dim() == 1:
            a = a_log                                        # shared (H,)
        else:
            a = a_log.movedim(ad, 0) if ad is not None \
                else a_log.expand(V, *a_log.shape)
            if a.dim() == 2:                                 # (V, H)
                a = a[:, None, :].expand(V, rows, a.shape[-1])
            a = a.reshape(V * rows, a.shape[-1])
        y = SSDScan.apply(xf, fold(dt, in_dims[1]), a,
                          fold(B_mat, in_dims[3]), fold(C_mat, in_dims[4]),
                          chunk)
        return y.reshape(V, rows, *y.shape[1:]), 0


def ssd_scan(x, dt, a_log, B_mat, C_mat, chunk: int):
    """The differentiable, vmappable SSD scan of :class:`SSDScan`."""
    return SSDScan.apply(x, dt, a_log, B_mat, C_mat, chunk)


def mamba2_forward(cfg: ArchConfig, p, x, *, use_kernel: bool = False):
    """Full-sequence Mamba2 block. x: (B,S,d) -> (B,S,d).  ``use_kernel``
    runs the scan through :class:`SSDScan` (the CUDA kernel on the card),
    else through :func:`ssd_chunked`."""
    s = cfg.ssm
    d_inner, n_heads, _ = dims(cfg)
    dt_ = x.dtype
    proj = x @ p["in_proj"].to(dt_)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    gn = s.n_groups * s.state_dim
    xs, Bm, Cm = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    Bb, S = x.shape[:2]
    xs = xs.reshape(Bb, S, n_heads, s.head_dim)
    Bm = Bm.reshape(Bb, S, s.n_groups, s.state_dim)
    Cm = Cm.reshape(Bb, S, s.n_groups, s.state_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    scan = ssd_scan if use_kernel else ssd_chunked
    y = scan(xs, dt, p["a_log"], Bm, Cm, chunk=s.chunk)
    y = y + p["d_skip"].float()[None, None, :, None] * xs.float()
    y = y.reshape(Bb, S, d_inner).to(dt_)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt_)


# ---------------------------------------------------------------------------
# decode: O(1) recurrence
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, device):
    s = cfg.ssm
    d_inner, n_heads, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, n_heads, s.head_dim, s.state_dim),
                             dtype=torch.float32, device=device),
    }


def mamba2_decode(cfg: ArchConfig, p, x, cache) -> Tuple[torch.Tensor, dict]:
    """One-token step. x: (B,1,d) -> (out (B,1,d), new cache)."""
    s = cfg.ssm
    d_inner, n_heads, conv_dim = dims(cfg)
    dt_ = x.dtype
    Bb = x.shape[0]
    proj = x[:, 0] @ p["in_proj"].to(dt_)                    # (B, proj)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(dt_)) \
        + p["conv_b"].to(dt_)
    xbc = F.silu(conv_out)
    new_conv = window[:, 1:, :]
    gn = s.n_groups * s.state_dim
    xs, Bm, Cm = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(Bb, n_heads, s.head_dim).float()
    Bm = Bm.reshape(Bb, s.n_groups, s.state_dim).float()
    Cm = Cm.reshape(Bb, s.n_groups, s.state_dim).float()
    rep = n_heads // s.n_groups
    Bm = Bm.repeat_interleave(rep, dim=1)                    # (B,H,N)
    Cm = Cm.repeat_interleave(rep, dim=1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())   # (B,H)
    A = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * A)                                   # (B,H)
    state = cache["state"] * da[:, :, None, None] \
        + torch.einsum("bh,bhn,bhp->bhpn", dt, Bm, xs)
    y = torch.einsum("bhpn,bhn->bhp", state, Cm)
    y = y + p["d_skip"].float()[None, :, None] * xs
    y = y.reshape(Bb, d_inner).to(dt_)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = (y @ p["out_proj"].to(dt_))[:, None, :]
    return out, {"conv": new_conv, "state": state}
