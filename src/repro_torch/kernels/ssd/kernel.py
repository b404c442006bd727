"""Hopper kernels for the Mamba2 SSD chunked scan, bound through ctypes.

:func:`ssd_fwd` replaces the TPU kernel ``src/repro/kernels/ssd/kernel.py:73``
(``ssd_fwd``, body ``_ssd_kernel`` at ``:24``).  Every full-sequence Mamba2
block on the card runs it once (``repro_torch.models.mamba2.mamba2_forward``
with ``use_kernel=True``): each forward evaluation of the LM loss or of
``prefill_logits`` calls it once per layer.  It is CUDA C++ for ``sm_90a`` in
``repro_torch/csrc/ssd.cu``, built by :mod:`repro_torch.kernels._build` at
first use: three kernels, chunk-parallel (the chunks' end states, a pass
that carries the state across chunks, the chunk scan), of which only the
last runs when the sequence is one chunk.  The source note says what bounds
each and why bf16 products are split into hi and lo halves; :func:`plan`
says what a call launches, allocates and moves.

The wrapper checks its inputs and raises on anything the kernels do not
take: a tensor off the card, x/B/C of another dtype than f32 or bf16 (the
three alike), dt or a_log not f32, mismatched shapes, a non-contiguous
layout, P not 16, 32 or 64, N not a multiple of 16 up to 128, a chunk above
128 or not dividing S.  It allocates y (f32) and the f32 scratch of the
states with ``torch.empty``, launches on PyTorch's current stream, raises if
a launch reports a CUDA error (a refused shared-memory size included), and
counts the call in ``LAUNCHES["ssd_fwd"]`` and the kernels it launched in
``LAUNCHES["ssd_fwd_kernels"]``.  There is no fallback: the plain versions
in ``ref.py`` are for CPU tensors, picked by ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# calls of ssd_fwd, and the kernels they launched, since the last
# reset_launches(); bumped only where the kernels are launched
LAUNCHES = {"ssd_fwd": 0, "ssd_fwd_kernels": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_STATE, MAX_HEADS = 128, 128, 8
HEAD_DIMS = (16, 32, 64)
# blocks the host aims the chunk kernels' grids at: two per SM of an H100
TARGET_BLOCKS = 2 * 132


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Plan(NamedTuple):
    """What one :func:`ssd_fwd` call launches, allocates and moves."""
    chunk: int
    n_chunks: int
    heads_per_block: int
    head_tiles: int         # tiles of heads per group
    kernels: int            # 3, or 1 when the sequence is one chunk
    state_floats: int       # f32 scratch of the chunks' states
    decay_floats: int       # f32 scratch of exp(a_cum[l-1]) per chunk
    design_bytes: int       # device-memory bytes the three kernels move

    @property
    def scratch_bytes(self) -> int:
        return 4 * (self.state_floats + self.decay_floats)


def plan(rows: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
         x_bytes: int) -> Plan:
    """The launch plan of ``ssd_fwd`` at these shapes (``chunk`` cut to S).

    Heads per block: as many as ``MAX_HEADS`` allow (C.B^T and B are staged
    once per block), halved while the grid of (row, chunk, group, tile)
    blocks is below ``TARGET_BLOCKS``, then evened out over the tiles.
    ``design_bytes`` counts each kernel's reads and writes once: the chunks'
    end states (B once per block; x, dt and a_log once per head), the state
    pass (states and decays read, states written), the chunk scan (B and C
    once per block; x, dt, a_log and the entering state once per head; y
    written)."""
    chunk = min(chunk, S)
    nc, rep = S // chunk, H // G
    hb = min(rep, MAX_HEADS)
    while hb > 1 and rows * nc * G * math.ceil(rep / hb) < TARGET_BLOCKS:
        hb = math.ceil(hb / 2)
    tiles = math.ceil(rep / hb)
    hb = math.ceil(rep / tiles)
    slots = rows * (nc - 1)
    states, decays = slots * H * P * N, slots * H
    per_head = chunk * (P * x_bytes + 4) + 4
    k1 = (slots * (G * tiles * chunk * N * x_bytes + H * per_head)
          + 4 * (states + decays)) if nc > 1 else 0
    k2 = 4 * (2 * states + decays)
    k3 = (rows * nc * (G * tiles * 2 * chunk * N * x_bytes + H * per_head)
          + 4 * states + 4 * rows * S * H * P)
    return Plan(chunk, nc, hb, tiles, 3 if nc > 1 else 1, states, decays,
                k1 + k2 + k3)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ssd_fwd.argtypes = [p, p, p, p, i64, p, p, p, p] + [i32] * 9 \
        + [p, ctypes.POINTER(i32)]
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
    (B,S,G,N) -> y (B,S,H,P) f32; the kernels of :func:`plan`.  x, B and C are f32 or
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
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_fwd: head_dim P = {P} must be one of "
                         f"{HEAD_DIMS}")
    if not 0 < N <= MAX_STATE or N % 16:
        raise ValueError(f"ssd_fwd: state size N = {N} must be a multiple "
                         f"of 16 up to {MAX_STATE}")
    if Bb > 65535 or S // chunk > 65535:
        raise ValueError(f"ssd_fwd: B = {Bb} and S / chunk = {S // chunk} "
                         f"must be at most 65535 (grid limits)")
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    # the kernels move x, B and C in 16-byte pieces
    x, B_mat, C_mat = (t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (x, B_mat, C_mat))
    pl = plan(Bb, S, H, P, G, N, chunk, x.element_size())
    states = decay = None                 # a one-chunk sequence has none
    if pl.kernels > 1:
        scratch = torch.empty(pl.state_floats + pl.decay_floats,
                              dtype=torch.float32, device=dev)
        states = scratch.data_ptr()
        decay = states + 4 * pl.state_floats
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = _lib().ssd_fwd(
            y.data_ptr(), x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
            alog_stride, B_mat.data_ptr(), C_mat.data_ptr(), states, decay,
            Bb, S, H, P, G, N, chunk, pl.heads_per_block,
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream,
            ctypes.byref(launched))
    LAUNCHES["ssd_fwd_kernels"] += launched.value
    if err:
        msg = _lib().ssd_error_string(err).decode()
        raise RuntimeError(f"ssd_fwd: kernel launch failed with CUDA error "
                           f"{err} ({msg}) after {launched.value} of "
                           f"{pl.kernels} kernels")
    LAUNCHES["ssd_fwd"] += 1
    return y
