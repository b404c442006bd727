"""Hopper kernels for the server apply, bound through ctypes.

  * :func:`apply_scaled` -- ``w ← w − s·Δ``; replaces the TPU kernel
    ``src/repro/kernels/fused_update/kernel.py:229`` (``apply_scaled``).
    Every immediate apply runs it once per param leaf.
  * :func:`apply_rows` -- ``w ← w − Σᵢ sᵢ·Δᵢ`` over an ``[M, *w.shape]``
    stack; replaces ``kernel.py:129`` (``apply_rows``).  Every buffered and
    every sync flush runs it once per leaf, and so does every window apply
    of a server that banks deltas in fp32.
  * :func:`apply_rows_q` -- ``w ← w − Σᵢ (sᵢ·scaleᵢ)·qᵢ`` over an int8
    ``[M, *w.shape]`` stack with f32 row scales; replaces ``kernel.py:186``
    (``apply_rows_q``).  Every window apply of a server that banks deltas in
    int8 runs it once per leaf and contributing bank.

All three are CUDA C++ for ``sm_90a`` in ``repro_torch/csrc/fused_update.cu``,
built by :mod:`repro_torch.kernels._build` at first use.  Both are
memory-bound: their bound on the card is the bytes they move (``2n`` reads and
``n`` writes, or ``(M+1)·n`` reads and ``n`` writes, times the element size;
for ``apply_rows_q`` ``M·n`` int8 bytes, ``w`` read and written, and ``8M``
bytes of weights and scales) over 3.35 TB/s; the source notes say what the
design does about it.

Each wrapper checks its inputs and raises on anything the kernel does not
take: a tensor off the card, a dtype other than f32/bf16 (int8 for the
quantized stack, f32 for weights and scales), a mismatched shape,
a non-contiguous layout.  It allocates the output with ``torch.empty`` (the
apply is out of place), launches on PyTorch's current stream, raises if the
launch reports a CUDA error, and counts the launch in :data:`LAUNCHES`.
There is no fallback: the plain versions in ``ref.py`` are for CPU tensors,
picked by ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# launches per kernel since the last reset_launches(); bumped only where a
# kernel is launched
LAUNCHES = {"apply_scaled": 0, "apply_rows": 0, "apply_rows_q": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_update")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.fu_apply_scaled.argtypes = [p, p, p, ctypes.c_float, i64, i32, i32, p]
    lib.fu_apply_scaled.restype = i32
    lib.fu_apply_rows.argtypes = [p, p, p, p, i64, i64, i32, i32, p]
    lib.fu_apply_rows.restype = i32
    lib.fu_apply_rows_q.argtypes = [p, p, p, p, p, i64, i64, i32, p]
    lib.fu_apply_rows_q.restype = i32
    lib.fu_error_string.argtypes = [i32]
    lib.fu_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, arg: str, t: torch.Tensor, device=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {arg} must be a torch.Tensor, "
                        f"got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: {arg} is on {t.device}; the kernel takes "
                         f"CUDA tensors only (ops.py picks the plain version "
                         f"for CPU tensors)")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")


def _code(name: str, arg: str, t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{name}: {arg} has dtype {t.dtype}; the kernel "
                        f"takes float32 or bfloat16") from None


def _raise_on(name: str, err: int) -> None:
    if err:
        msg = _lib().fu_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} ({msg})")


def apply_scaled(w: torch.Tensor, d: torch.Tensor, scale: float
                 ) -> torch.Tensor:
    """``w − scale·d`` in f32, stored in ``w.dtype``; one kernel launch.

    ``scale`` is a host number passed by value, so the apply never waits on
    the device to read it; a tensor is refused for that reason.
    """
    name = "apply_scaled"
    _check(name, "w", w)
    _check(name, "d", d, w.device)
    if d.shape != w.shape:
        raise ValueError(f"{name}: d has shape {tuple(d.shape)}, "
                         f"w has {tuple(w.shape)}")
    if isinstance(scale, torch.Tensor):
        raise TypeError(f"{name}: scale must be a host number, not a tensor")
    wc, dc = _code(name, "w", w), _code(name, "d", d)
    out = torch.empty_like(w)
    n = w.numel()
    if n == 0:
        return out
    with torch.cuda.device(w.device):
        err = _lib().fu_apply_scaled(
            out.data_ptr(), w.data_ptr(), d.data_ptr(), float(scale), n, wc,
            dc, torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def apply_rows(w: torch.Tensor, d_stack: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """``w − Σᵢ weights[i]·d_stack[i]`` in f32, stored in ``w.dtype``; one
    kernel launch.  ``d_stack`` is ``[M, *w.shape]``, ``weights`` ``[M]``
    float32 on the same card."""
    name = "apply_rows"
    _check(name, "w", w)
    _check(name, "d_stack", d_stack, w.device)
    _check(name, "weights", weights, w.device)
    m = d_stack.shape[0] if d_stack.dim() else -1
    if d_stack.shape[1:] != w.shape or d_stack.dim() != w.dim() + 1:
        raise ValueError(f"{name}: d_stack has shape {tuple(d_stack.shape)}, "
                         f"expected [M, *{tuple(w.shape)}]")
    if weights.dtype != torch.float32 or weights.shape != (m,):
        raise ValueError(f"{name}: weights must be float32 of shape ({m},), "
                         f"got {weights.dtype} {tuple(weights.shape)}")
    wc, dc = _code(name, "w", w), _code(name, "d_stack", d_stack)
    out = torch.empty_like(w)
    n = w.numel()
    if n == 0:
        return out
    with torch.cuda.device(w.device):
        err = _lib().fu_apply_rows(
            out.data_ptr(), w.data_ptr(), d_stack.data_ptr(),
            weights.data_ptr(), m, n, wc, dc,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def apply_rows_q(w: torch.Tensor, q_stack: torch.Tensor,
                 scales: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``w − Σᵢ (weights[i]·scales[i])·float(q_stack[i])`` in f32, stored in
    ``w.dtype``; one kernel launch.  ``q_stack`` is int8 ``[M, *w.shape]``;
    ``scales`` and ``weights`` are ``[M]`` float32, all on ``w``'s card."""
    name = "apply_rows_q"
    _check(name, "w", w)
    _check(name, "q_stack", q_stack, w.device)
    _check(name, "scales", scales, w.device)
    _check(name, "weights", weights, w.device)
    m = q_stack.shape[0] if q_stack.dim() else -1
    if q_stack.shape[1:] != w.shape or q_stack.dim() != w.dim() + 1:
        raise ValueError(f"{name}: q_stack has shape {tuple(q_stack.shape)}, "
                         f"expected [M, *{tuple(w.shape)}]")
    if q_stack.dtype != torch.int8:
        raise TypeError(f"{name}: q_stack has dtype {q_stack.dtype}; the "
                        f"kernel takes int8 codes")
    for arg, t in (("scales", scales), ("weights", weights)):
        if t.dtype != torch.float32 or t.shape != (m,):
            raise ValueError(f"{name}: {arg} must be float32 of shape "
                             f"({m},), got {t.dtype} {tuple(t.shape)}")
    wc = _code(name, "w", w)
    out = torch.empty_like(w)
    n = w.numel()
    if n == 0:
        return out
    with torch.cuda.device(w.device):
        err = _lib().fu_apply_rows_q(
            out.data_ptr(), w.data_ptr(), q_stack.data_ptr(),
            weights.data_ptr(), scales.data_ptr(), m, n, wc,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out
