"""Attention, as in ``src/repro/models/attention.py``: GQA, sliding windows,
logit softcap and QKV bias, and DeepSeek-V3's Multi-head Latent Attention
(MLA).

Three execution paths:

  * full-sequence attention (train / prefill) without a per-layer
    ``local_flag`` goes through :class:`FlashAttention`, whose forward is
    ``kernels.flash_attention.ops.flash_attention`` -- the hand-written CUDA
    kernel ``flash_attention_fwd`` for CUDA tensors, the plain
    ``attention_ref`` for CPU tensors: causal self-attention, with or
    without a window, bidirectional self-attention (whisper's encoder) and
    cross-attention to keys of another length (whisper's decoder against
    the encoder's frames);
  * a per-layer ``local_flag`` (a traced flag in the reference) and
    single-token decode against a KV cache (self or cross) run the plain
    :func:`sdpa`, as the reference computes them outside any kernel;
  * MLA runs in plain PyTorch, as in the reference: prefill materializes
    per-head k and v (its q.k head is not its v head, and the kernel takes
    equal head dims), decode attends in the latent space (absorbed form).

The one intended difference from the reference: its ``attn_forward`` calls
the plain ``sdpa`` everywhere (the Pallas kernel is validated on its own),
while the port runs the kernel when the activations lie on the card.  On
the CPU both packages compute the same plain attention, so the parity tests
compare like with like.

Softmax is always computed in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import apply_rope, dense_init, softcap

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# standard (GQA) attention
# ---------------------------------------------------------------------------

def init_attn(generator: torch.Generator, cfg: ArchConfig,
              d_in: Optional[int] = None):
    """Params on the CPU, drawn from ``generator``; ``d_in`` lets hybrid
    blocks feed concat(h, emb) (zamba2)."""
    d = cfg.d_model
    d_in = d_in or d
    hd = cfg.resolved_head_dim
    p = {"wq": dense_init(generator, (d_in, cfg.n_heads * hd)),
         "wk": dense_init(generator, (d_in, cfg.n_kv_heads * hd)),
         "wv": dense_init(generator, (d_in, cfg.n_kv_heads * hd)),
         "wo": dense_init(generator, (cfg.n_heads * hd, d))}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=torch.float32)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=torch.float32)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=torch.float32)
    return p


def _project_qkv(cfg: ArchConfig, p, x, kv_x=None):
    """-> q (B,S,Hq,hd), k/v (B,Skv,Hkv,hd)."""
    dt = x.dtype
    hd = cfg.resolved_head_dim
    kv_x = x if kv_x is None else kv_x
    q = x @ p["wq"].to(dt)
    k = kv_x @ p["wk"].to(dt)
    v = kv_x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    B = x.shape[0]
    q = q.reshape(B, x.shape[1], cfg.n_heads, hd)
    k = k.reshape(B, kv_x.shape[1], cfg.n_kv_heads, hd)
    v = v.reshape(B, kv_x.shape[1], cfg.n_kv_heads, hd)
    return q, k, v


def sdpa(q, k, v, *, mask=None, cap: float = 0.0):
    """Grouped scaled-dot-product attention.

    q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd); Hq % Hkv == 0.
    mask: broadcastable to (B,1,1,S,T), True = attend.
    """
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, S, Hkv, group, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * hd ** -0.5
    logits = softcap(logits, cap)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, Hq, hd)


def causal_mask(S: int, T: int, q_offset, window: int = 0, local_flag=None,
                device=None):
    """(1,1,1,S,T) boolean mask, True = attend.  ``local_flag`` (a bool or
    a boolean tensor) False disables the window, as gemma2's global layers
    need."""
    qi = q_offset + torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window:
        win = kj > qi - window
        if local_flag is not None:
            win = win | torch.logical_not(torch.as_tensor(local_flag,
                                                          device=device))
        m = m & win
    return m[None, None, None]


class FlashAttention(torch.autograd.Function):
    """Attention through ``kernels.flash_attention.ops`` with the gradient
    of its plain version: q (B,S,Hq,hd) against k, v (B,T,Hkv,hd), causal
    (offset 0) or not, with a window and a softcap.

    * forward: ``fa_ops.flash_attention(..., mode="auto")`` -- the CUDA
      kernel ``flash_attention_fwd`` for CUDA tensors, ``attention_ref`` for
      CPU tensors;
    * backward: the vjp of ``attention_ref`` with the same ``causal`` on the
      saved q, k, v, so that the CPU forward and the gradient are one
      function; it computes what the reference differentiates (its ``sdpa``
      with ``causal_mask``, or with no mask; it has no backward kernel).
      The logits are recomputed in plain PyTorch: that is the price of
      having no backward kernel (ROADMAP follow-up);
    * vmap: folds the vmapped dim into the batch dim (an unbatched operand
      is expanded over it) and calls the Function once, so
      ``vmap(grad(loss))`` over a cohort launches the kernel once per
      invocation and forward evaluation, whatever the cohort size.  The rule
      does not look at the device, so the CPU tests exercise it through the
      plain forward.

    * jvp: the jvp of ``attention_ref`` on the saved q, k, v, so that
      Option B's exact Hessian-vector product (``maml_mode="full"``,
      ``torch.func.jvp`` of ``torch.func.grad``: gemma2-2b's,
      codeqwen1.5-7b's, minitron-8b's and whisper-large-v3's) runs forward
      mode through the kernel's forward and the plain backward.
    """

    @staticmethod
    def forward(q, k, v, causal, window, cap):
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=cap, mode="auto")

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, cap = inputs
        ctx.save_for_backward(q, k, v)
        ctx.save_for_forward(q, k, v)
        ctx.causal, ctx.window, ctx.cap = causal, window, cap

    @staticmethod
    def _plain(ctx):
        causal, window, cap = ctx.causal, ctx.window, ctx.cap

        def plain(q, k, v):
            return attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=cap)
        return plain

    @staticmethod
    def backward(ctx, g):
        _, vjp_fn = torch.func.vjp(FlashAttention._plain(ctx),
                                   *ctx.saved_tensors)
        return (*vjp_fn(g), None, None, None)

    @staticmethod
    def jvp(ctx, tq, tk, tv, *_):
        primals = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, (tq, tk, tv)))
        return torch.func.jvp(FlashAttention._plain(ctx), primals,
                              tangents)[1]

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, cap):
        V = info.batch_size

        def fold(t, d):
            # (V, rows, ...) -> (V * rows, ...), broadcasting an unbatched
            # operand over the vmapped dim
            t = t.movedim(d, 0) if d is not None else t.expand(V, *t.shape)
            return t.reshape(V * t.shape[1], *t.shape[2:])

        out = FlashAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                   fold(v, in_dims[2]), causal, window, cap)
        return out.reshape(V, out.shape[0] // V, *out.shape[1:]), 0


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0):
    """The differentiable, vmappable attention of :class:`FlashAttention`;
    k, v may be of another length than q."""
    return FlashAttention.apply(q, k, v, causal, window, cap)


def attn_forward(cfg: ArchConfig, p, x, *, positions, window: int = 0,
                 local_flag=None, kv_x=None, kv_positions=None,
                 causal: bool = True):
    """Full-sequence attention (train / prefill / encoder / cross).
    Without a ``local_flag`` it runs :class:`FlashAttention`: causal (offset
    0, the window applied) or, with ``causal=False``, unmasked, as the
    reference's ``sdpa`` with no mask; self-attention or cross-attention to
    ``kv_x``.  A ``local_flag`` runs the plain :func:`sdpa`."""
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        kpos = kv_positions if kv_positions is not None else positions
        k = apply_rope(k, kpos, cfg.rope_theta)
    if local_flag is None:
        # the reference's mask is None without causal: no window either
        out = flash_attention(q, k, v, causal=causal,
                              window=window if causal else 0,
                              cap=cfg.attn_softcap)
    else:
        mask = causal_mask(q.shape[1], k.shape[1], 0, window, local_flag,
                           device=q.device) if causal else None
        out = sdpa(q, k, v, mask=mask, cap=cfg.attn_softcap)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"].to(x.dtype), (k, v)


def _write_row(cache, row, pos: int):
    """``cache`` (B,T,...) with row ``pos`` replaced by ``row`` (B,1,...),
    functionally (``torch.func.vmap`` runs decode over users).  The start
    is clamped into the cache as ``lax.dynamic_update_slice`` clamps it."""
    pos = min(max(int(pos), 0), cache.shape[1] - 1)
    return torch.cat([cache[:, :pos], row.to(cache.dtype),
                      cache[:, pos + 1:]], dim=1)


def attn_decode(cfg: ArchConfig, p, x, k_cache, v_cache, pos, *,
                window: int = 0, local_flag=None, rope: bool = True,
                mask_pos=None, rope_pos=None):
    """One-token decode. x: (B,1,d_in); caches: (B,T,Hkv,hd); pos an int.

    ``mask_pos`` overrides the causal-mask position and ``rope_pos`` the
    rotary position (ring-buffer caches write at ``pos`` = slot while the
    rotary/mask positions stay absolute).
    Returns (out (B,1,d), new_k_cache, new_v_cache).
    """
    q, k, v = _project_qkv(cfg, p, x)
    if rope:
        rp = pos if rope_pos is None else rope_pos
        posv = torch.full((x.shape[0], 1), int(rp), dtype=torch.int32,
                          device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    k_cache = _write_row(k_cache, k, pos)
    v_cache = _write_row(v_cache, v, pos)
    T = k_cache.shape[1]
    kj = torch.arange(T, device=x.device)
    mpos = pos if mask_pos is None else mask_pos
    m = kj <= mpos
    if window:
        win = kj > mpos - window
        if local_flag is not None:
            win = win | torch.logical_not(torch.as_tensor(local_flag,
                                                          device=x.device))
        m = m & win
    mask = m[None, None, None, None, :]
    out = sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask=mask,
               cap=cfg.attn_softcap)
    B = x.shape[0]
    return out.reshape(B, 1, -1) @ p["wo"].to(x.dtype), k_cache, v_cache


def cross_attn_decode(cfg: ArchConfig, p, x, enc_k, enc_v):
    """Decode-time cross-attention against the precomputed encoder K/V:
    x (B,1,d); enc_k, enc_v (B,T,Hkv,hd) -> (B,1,d).  The plain
    :func:`sdpa` with no mask, as ``attn_decode``'s single token."""
    dt = x.dtype
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    q = (x @ p["wq"].to(dt)).reshape(B, 1, cfg.n_heads, hd)
    if "bq" in p:
        q = q + p["bq"].to(dt).reshape(1, 1, cfg.n_heads, hd)
    out = sdpa(q, enc_k.to(dt), enc_v.to(dt), mask=None,
               cap=cfg.attn_softcap)
    return out.reshape(B, 1, -1) @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# DeepSeek-V3 Multi-head Latent Attention (MLA)
# ---------------------------------------------------------------------------

def init_mla(generator: torch.Generator, cfg: ArchConfig):
    """Params on the CPU, drawn from ``generator``: the query's and the
    key/value's low-rank down and up projections, the shared rotary key and
    the output."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"w_dq": dense_init(generator, (d, m.q_lora_rank)),
            "w_uq": dense_init(generator, (m.q_lora_rank, H * qk_head)),
            "w_dkv": dense_init(generator, (d, m.kv_lora_rank)),
            "w_krope": dense_init(generator, (d, m.qk_rope_head_dim)),
            "w_uk": dense_init(generator,
                               (m.kv_lora_rank, H * m.qk_nope_head_dim)),
            "w_uv": dense_init(generator, (m.kv_lora_rank, H * m.v_head_dim)),
            "wo": dense_init(generator, (H * m.v_head_dim, d))}


def _mla_q(cfg: ArchConfig, p, x, positions):
    """-> q_nope (B,S,H,nope), q_rope (B,S,H,rope) rotated."""
    m, H = cfg.mla, cfg.n_heads
    dt = x.dtype
    B, S = x.shape[:2]
    q = (x @ p["w_dq"].to(dt)) @ p["w_uq"].to(dt)
    q = q.reshape(B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope


def _mla_scale(m) -> float:
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def mla_forward(cfg: ArchConfig, p, x, *, positions):
    """Full-sequence MLA (train / prefill), per-head k and v materialized,
    in plain PyTorch as the reference computes it: its q.k head (nope +
    rope, 192 at full width) is not its v head (128), and the attention
    kernel takes equal head dims.  Returns (out (B,S,d), (c_kv, k_rope))."""
    m, H = cfg.mla, cfg.n_heads
    dt = x.dtype
    B, S = x.shape[:2]
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv = x @ p["w_dkv"].to(dt)                             # (B,S,r_kv)
    # one rotary key head, shared by every query head
    k_rope = apply_rope((x @ p["w_krope"].to(dt))[:, :, None, :],
                        positions, cfg.rope_theta)           # (B,S,1,rope)
    k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(B, S, H, m.qk_nope_head_dim)
    v = (c_kv @ p["w_uv"].to(dt)).reshape(B, S, H, m.v_head_dim)
    logits = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btod->bhst", q_rope, k_rope))
    logits = logits.float() * _mla_scale(m)
    mask = causal_mask(S, S, 0, device=x.device)[:, :, 0]   # (1,1,S,T)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, -1)
    return out @ p["wo"].to(dt), (c_kv, k_rope[:, :, 0, :])


def mla_decode(cfg: ArchConfig, p, x, ckv_cache, krope_cache, pos):
    """Absorbed-matrix MLA decode, attending in the latent space:
    ``W_uk`` goes into the query and ``W_uv`` into the output, so the cache
    stays (B,T,kv_lora) + (B,T,rope).  x (B,1,d); pos an int.  Returns
    (out (B,1,d), new ckv cache, new krope cache)."""
    m, H = cfg.mla, cfg.n_heads
    dt = x.dtype
    B = x.shape[0]
    posv = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, posv)                 # (B,1,H,.)
    c_kv = x @ p["w_dkv"].to(dt)                             # (B,1,r)
    k_rope = apply_rope((x @ p["w_krope"].to(dt))[:, :, None, :], posv,
                        cfg.rope_theta)[:, :, 0, :]          # (B,1,rope)
    ckv_cache = _write_row(ckv_cache, c_kv, pos)
    krope_cache = _write_row(krope_cache, k_rope, pos)
    w_uk = p["w_uk"].to(dt).reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)     # (B,1,H,r)
    ckv = ckv_cache.to(dt)
    logits = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
              + torch.einsum("bshd,btd->bhst", q_rope, krope_cache.to(dt)))
    logits = logits.float() * _mla_scale(m)
    mask = torch.arange(ckv_cache.shape[1], device=x.device) <= pos
    logits = logits.masked_fill(~mask[None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dt)
    ctx = torch.einsum("bhst,btr->bshr", probs, ckv)         # (B,1,H,r)
    w_uv = p["w_uv"].to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhd->bshd", ctx, w_uv).reshape(B, 1, -1)
    return out @ p["wo"].to(dt), ckv_cache, krope_cache
