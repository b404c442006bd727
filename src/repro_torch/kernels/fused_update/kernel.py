"""Hopper kernels for the local steps and the server apply, bound through
ctypes.

  * :func:`sgd_step` -- ``w ← w − η·g``; replaces the TPU kernel
    ``src/repro/kernels/fused_update/kernel.py:78`` (``sgd_step``).
  * :func:`prox_inner` -- ``θ ← θ − η_in·(g + λ·(θ − w))``; replaces
    ``kernel.py:83`` (``prox_inner``).
  * :func:`prox_outer` -- ``w ← w − (ηλ)·(w − θ)``; replaces ``kernel.py:90``
    (``prox_outer``).  The three run through the tree fronts of ``ops.py``
    (``sgd_step_tree`` etc.), which only their callers reach: as in the
    reference, ``client_update`` computes its steps in plain tensor code.
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

All six are CUDA C++ for ``sm_90a`` in ``repro_torch/csrc/fused_update.cu``,
built by :mod:`repro_torch.kernels._build` at first use.  All are
memory-bound: their bound on the card is the bytes they move (``2n`` reads and
``n`` writes -- ``3n`` reads for ``prox_inner`` -- or ``(M+1)·n`` reads and
``n`` writes, times the element size; for ``apply_rows_q`` ``M·n`` int8
bytes, ``w`` read and written, and ``8M`` bytes of weights and scales) over
3.35 TB/s; the source notes say what the design does about it.

Each wrapper checks its inputs and raises on anything the kernel does not
take: a tensor off the card, a dtype other than f32/bf16 (int8 for the
quantized stack, f32 for weights and scales), a mismatched shape,
a non-contiguous layout.  It allocates the output with ``torch.empty`` (the
update is out of place, in the first operand's dtype), launches on PyTorch's
current stream, raises if the launch reports a CUDA error, and counts the
launch in :data:`LAUNCHES`.
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
LAUNCHES = {"sgd_step": 0, "prox_inner": 0, "prox_outer": 0,
            "apply_scaled": 0, "apply_rows": 0, "apply_rows_q": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_update")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    f32 = ctypes.c_float
    lib.fu_sgd_step.argtypes = [p, p, p, f32, i64, i32, i32, p]
    lib.fu_sgd_step.restype = i32
    lib.fu_prox_inner.argtypes = [p, p, p, p, f32, f32, i64, i32, i32, i32, p]
    lib.fu_prox_inner.restype = i32
    lib.fu_prox_outer.argtypes = [p, p, p, f32, i64, i32, i32, p]
    lib.fu_prox_outer.restype = i32
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


def _elementwise(name: str, args, scalars) -> torch.Tensor:
    """Checks ``args`` (``(arg name, tensor)`` pairs, the first the output's
    template), launches ``fu_<name>`` once over them with the host floats
    ``scalars`` and counts the launch.  Scalars pass by value as C floats,
    so the launch never waits on the device; a tensor is refused."""
    (first, x), rest = args[0], args[1:]
    _check(name, first, x)
    for arg, t in rest:
        _check(name, arg, t, x.device)
        if t.shape != x.shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"{first} has {tuple(x.shape)}")
    for s in scalars:
        if isinstance(s, torch.Tensor):
            raise TypeError(f"{name}: scalars must be host numbers, not "
                            f"tensors")
    codes = [_code(name, arg, t) for arg, t in args]
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    ptrs = [t.data_ptr() for _, t in args]
    with torch.cuda.device(x.device):
        err = getattr(_lib(), f"fu_{name}")(
            out.data_ptr(), *ptrs, *(float(s) for s in scalars), n, *codes,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def sgd_step(w: torch.Tensor, g: torch.Tensor, eta: float) -> torch.Tensor:
    """``w − η·g`` in f32, stored in ``w.dtype``; one kernel launch."""
    return _elementwise("sgd_step", (("w", w), ("g", g)), (eta,))


def prox_inner(theta: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
               eta_in: float, lam: float) -> torch.Tensor:
    """``θ − η_in·(g + λ·(θ − w))`` in f32, stored in ``theta.dtype``; one
    kernel launch."""
    return _elementwise("prox_inner", (("theta", theta), ("g", g), ("w", w)),
                        (eta_in, lam))


def prox_outer(w: torch.Tensor, theta: torch.Tensor, eta: float,
               lam: float) -> torch.Tensor:
    """``w − (ηλ)·(w − θ)`` in f32, stored in ``w.dtype``; one kernel
    launch.  ηλ is formed in double and rounded to f32 once, as the
    reference's ``eta * lam * (w − θ)`` rounds it."""
    return _elementwise("prox_outer", (("w", w), ("theta", theta)),
                        (eta * lam,))


def apply_scaled(w: torch.Tensor, d: torch.Tensor, scale: float
                 ) -> torch.Tensor:
    """``w − scale·d`` in f32, stored in ``w.dtype``; one kernel launch.

    ``scale`` is a host number passed by value, so the apply never waits on
    the device to read it; a tensor is refused for that reason.
    """
    return _elementwise("apply_scaled", (("w", w), ("d", d)), (scale,))


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
