"""Hopper kernel for forward flash attention, bound through ctypes.

:func:`flash_attention_fwd` replaces the TPU kernel
``src/repro/kernels/flash_attention/kernel.py:69`` (``flash_attention_fwd``,
body ``_flash_kernel`` at ``:24``), both its branches: causal or not, and
keys of any length T beside the queries' S.  Every full-sequence attention
on the card without a per-layer ``local_flag`` runs it once
(``repro_torch.models.attention.attn_forward`` through its
``FlashAttention`` autograd Function): causal self-attention, whisper's
bidirectional encoder and its decoder's cross-attention to the encoder's
frames; zamba2's shared block launches it once per invocation and forward
evaluation.  It is CUDA C++ for ``sm_90a``
in ``repro_torch/csrc/flash_attention.cu``, built by
:mod:`repro_torch.kernels._build` at first use; the source note says what
bounds it (operations, at the bf16 tensor cores' 989 TFLOP/s) and what the
design does about it.  bf16, at every head dim (:data:`WGMMA_HEAD_DIMS`),
runs ``flash_attention_fwd_wgmma``: wgmma products fed by TMA through a ring
of K/V tiles of :data:`WGMMA_BLOCK_K` keys, 128 at head dims 64 and 128 and
64 at 256 (gemma2's, whose 128-key tiles would not fit shared memory).
f32 runs ``flash_attention_fwd_kernel`` on the CUDA cores, with key tiles
of :data:`TILE`.  :func:`key_tile` says which tile a call walks, the
``block_k`` of the plain model ``ref.attention_tiles_ref``.

The wrapper checks its inputs and raises on anything the kernel does not
take: a tensor off the card, q/k/v not all f32 or all bf16, shapes other
than q (B,S,Hq,hd) and k, v (B,T,Hkv,hd) with T >= 1 and Hq a multiple of
Hkv, hd not 64, 128 or 256, a non-contiguous layout, a negative window or
softcap.  It allocates the output (q's dtype) with ``torch.empty``,
refuses bf16 tensors that do not start on 16 bytes (the tensor maps need
it), launches on PyTorch's current stream, raises if the launch reports a
CUDA error (a refused shared-memory size included), and counts the launch
in :data:`LAUNCHES`.  There is no fallback: the plain version in ``ref.py`` is
for CPU tensors, picked by ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches since the last reset_launches(); bumped only where the kernel is
# launched
LAUNCHES = {"flash_attention_fwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
TILE = 64                      # CUDA-core kernel: query and key rows a tile
WGMMA_HEAD_DIMS = (64, 128, 256)  # bf16 head dims on the wgmma kernel
WGMMA_BLOCK_Q = 128            # its query rows a block
WGMMA_BLOCK_K = {64: 128, 128: 128, 256: 64}  # its key rows a tile, by hd


def key_tile(dtype: torch.dtype, head_dim: int) -> int:
    """Key rows a tile of the kernel that runs ``dtype`` at ``head_dim``."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return WGMMA_BLOCK_K[head_dim]
    return TILE


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    # out, q, k, v, rows, S, T, Hq, Hkv, head_dim, window, causal,
    # softcap, dtype, stream
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i32, i32, i32, i32, i32,
                                        i32, i32, i32, ctypes.c_float, i32,
                                        p]
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(arg: str, t: torch.Tensor, device=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"flash_attention_fwd: {arg} must be a "
                        f"torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: {arg} is on {t.device}; the "
                         f"kernel takes CUDA tensors only (ops.py picks the "
                         f"plain version for CPU tensors)")
    if device is not None and t.device != device:
        raise ValueError(f"flash_attention_fwd: {arg} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention_fwd: {arg} must be contiguous")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd) -> (B,S,Hq,hd) in q's dtype; one
    kernel launch.  q, k and v are f32 or bf16, all three alike; query row
    i (at position i, whatever T is) sees key j iff j < T, j <= i where
    ``causal``, and i - window < j where ``window`` > 0; ``softcap`` > 0
    caps the logits as cap·tanh(x/cap) before the mask.  A row that sees
    no key (a window that ends before T) gets zeros, as
    ``attention_tiles_ref`` gives it (``attention_ref`` and the TPU kernel
    give the mean of v; no model path makes such a row)."""
    _check("q", q)
    dev = q.device
    _check("k", k, dev)
    _check("v", v, dev)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention_fwd: q must be (B,S,Hq,hd) and "
                         f"k (B,T,Hkv,hd), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, Hkv, hd) or tuple(v.shape) != tuple(k.shape) \
            or T < 1:
        raise ValueError(f"flash_attention_fwd: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be ({B}, T, Hkv, "
                         f"{hd}) with T >= 1")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_fwd: Hq = {Hq} is not a multiple "
                         f"of Hkv = {Hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} must be one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: q, k and v must all be "
                        f"float32 or all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention_fwd: window {window} and softcap "
                         f"{softcap} must be >= 0")
    if B > 65535 or Hq > 65535 or max(S, T) > 2 ** 31 - WGMMA_BLOCK_Q:
        raise ValueError(f"flash_attention_fwd: B = {B} and Hq = {Hq} must "
                         f"be at most 65535 (grid limits), S = {S} and T = "
                         f"{T} below 2^31")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: bf16 q, k and v must start "
                         "on a 16-byte boundary (TMA tensor maps)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().flash_attention_fwd(
            out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S,
            T, Hq, Hkv, hd, int(window), int(bool(causal)), float(softcap),
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        msg = _lib().flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with "
                           f"CUDA error {err} ({msg})")
    LAUNCHES["flash_attention_fwd"] += 1
    return out
