"""Hopper kernel for the Mamba2 SSD chunked scan, bound through ctypes.

:func:`ssd_fwd` replaces the TPU kernel ``src/repro/kernels/ssd/kernel.py:73``
(``ssd_fwd``, body ``_ssd_kernel`` at ``:24``).  Every full-sequence Mamba2
block on the card runs it once (``repro_torch.models.mamba2.mamba2_forward``
with ``use_kernel=True``): each forward evaluation of the LM loss or of
``prefill_logits`` launches it once per layer.  It is CUDA C++ for ``sm_90a``
in ``repro_torch/csrc/ssd.cu``, built by :mod:`repro_torch.kernels._build` at
first use; the source note says what bounds it (operations, at the f32 peak
of the CUDA cores) and what the design does about it.

The wrapper checks its inputs and raises on anything the kernel does not
take: a tensor off the card, x/B/C of another dtype than f32 or bf16 (the
three alike), dt or a_log not f32, mismatched shapes, a non-contiguous
layout, P not a multiple of 16, N not a power of two up to 128, a chunk
above 128 or not dividing S.  It allocates y (f32) with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch reports a CUDA
error (a refused shared-memory size included), and counts the launch in
:data:`LAUNCHES`.  There is no fallback: the plain version in ``ref.py`` is
for CPU tensors, picked by ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches since the last reset_launches(); bumped only where the kernel is
# launched
LAUNCHES = {"ssd_fwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, P_TILE, MAX_STATE = 128, 16, 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ssd_fwd.argtypes = [p, p, p, p, i64, p, p, i32, i32, i32, i32, i32,
                            i32, i32, i32, p]
    lib.ssd_fwd.restype = i32
    lib.ssd_error_string.argtypes = [i32]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def _check(arg: str, t: torch.Tensor, device=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"ssd_fwd: {arg} must be a torch.Tensor, "
                        f"got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"ssd_fwd: {arg} is on {t.device}; the kernel takes "
                         f"CUDA tensors only (ops.py picks the plain version "
                         f"for CPU tensors)")
    if device is not None and t.device != device:
        raise ValueError(f"ssd_fwd: {arg} is on {t.device}, expected "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"ssd_fwd: {arg} must be contiguous")


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            B_mat: torch.Tensor, C_mat: torch.Tensor, *,
            chunk: int = 128) -> torch.Tensor:
    """x: (B,S,H,P); dt: (B,S,H) f32; a_log: (H,) or (B,H) f32; B_mat/C_mat:
    (B,S,G,N) -> y (B,S,H,P) f32; one kernel launch.  x, B and C are f32 or
    bf16, all three alike.  ``chunk`` is cut to S, as in the reference."""
    _check("x", x)
    dev = x.device
    for arg, t in (("dt", dt), ("a_log", a_log), ("B_mat", B_mat),
                   ("C_mat", C_mat)):
        _check(arg, t, dev)
    if x.dim() != 4 or B_mat.dim() != 4:
        raise ValueError(f"ssd_fwd: x must be (B,S,H,P) and B_mat (B,S,G,N), "
                         f"got {tuple(x.shape)} and {tuple(B_mat.shape)}")
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if tuple(B_mat.shape) != (Bb, S, G, N) \
            or tuple(C_mat.shape) != (Bb, S, G, N):
        raise ValueError(f"ssd_fwd: B_mat {tuple(B_mat.shape)} and C_mat "
                         f"{tuple(C_mat.shape)} must both be ({Bb}, {S}, G, "
                         f"N)")
    if tuple(dt.shape) != (Bb, S, H):
        raise ValueError(f"ssd_fwd: dt has shape {tuple(dt.shape)}, "
                         f"expected {(Bb, S, H)}")
    if tuple(a_log.shape) == (H,):
        alog_stride = 0
    elif tuple(a_log.shape) == (Bb, H):
        alog_stride = H
    else:
        raise ValueError(f"ssd_fwd: a_log has shape {tuple(a_log.shape)}, "
                         f"expected ({H},) or ({Bb}, {H})")
    if x.dtype not in _DTYPE_CODES or B_mat.dtype != x.dtype \
            or C_mat.dtype != x.dtype:
        raise TypeError(f"ssd_fwd: x, B_mat and C_mat must all be float32 or "
                        f"all bfloat16, got {x.dtype}, {B_mat.dtype}, "
                        f"{C_mat.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"ssd_fwd: dt and a_log must be float32, got "
                        f"{dt.dtype} and {a_log.dtype}")
    chunk = min(chunk, S)
    if not 0 < chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_fwd: chunk {chunk} must be in [1, "
                         f"{MAX_CHUNK}] and divide S = {S}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_fwd: H = {H} is not a multiple of G = {G}")
    if P % P_TILE:
        raise ValueError(f"ssd_fwd: head_dim P = {P} must be a multiple of "
                         f"{P_TILE}")
    if not 0 < N <= MAX_STATE or N & (N - 1):
        raise ValueError(f"ssd_fwd: state size N = {N} must be a power of "
                         f"two up to {MAX_STATE}")
    if Bb > 65535 or H > 65535:
        raise ValueError(f"ssd_fwd: B = {Bb} and H = {H} must be at most "
                         f"65535 (grid limits)")
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    with torch.cuda.device(dev):
        err = _lib().ssd_fwd(
            y.data_ptr(), x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
            alog_stride, B_mat.data_ptr(), C_mat.data_ptr(), Bb, S, H, P, G,
            N, chunk, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = _lib().ssd_error_string(err).decode()
        raise RuntimeError(f"ssd_fwd: kernel launch failed with CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["ssd_fwd"] += 1
    return y
