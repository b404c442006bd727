"""Hopper kernels for the local steps and the server apply, bound through
ctypes.

  * :func:`sgd_step_leaves` -- ``w ← w − η·g`` over a list of leaves;
    replaces the TPU kernel ``src/repro/kernels/fused_update/kernel.py:78``
    (``sgd_step``).
  * :func:`prox_inner` -- ``θ ← θ − η_in·(g + λ·(θ − w))``; replaces
    ``kernel.py:83`` (``prox_inner``).
  * :func:`prox_outer_leaves` -- ``w ← w − (ηλ)·(w − θ)`` over a list of
    leaves; replaces ``kernel.py:90`` (``prox_outer``).  The three run
    through the tree fronts of ``ops.py`` (``sgd_step_tree`` etc.), which
    only their callers reach: as in the reference, ``client_update``
    computes its steps in plain tensor code.
  * :func:`apply_scaled_leaves` -- ``w ← w − s·Δ`` over a list of leaves;
    replaces the TPU kernel ``src/repro/kernels/fused_update/kernel.py:229``
    (``apply_scaled``).  Every immediate apply runs it once per param tree.
  * :func:`apply_rows_leaves` -- ``w ← w − Σᵢ sᵢ·Δᵢ`` over a list of leaves
    and their ``[M, *w.shape]`` stacks; replaces ``kernel.py:129``
    (``apply_rows``).  Every buffered and every sync flush runs it once per
    param tree, and so does every window apply of a server that banks
    deltas in fp32.
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

The four leaf-list wrappers launch once per tree: :func:`plan_launches`
groups the leaves by dtype pair, drops empty ones, cuts each group into
chunks of at most ``fu_max_leaves()`` leaves and flags the leaves whose
pointers (and, for a stack, whose every row) are 16-byte aligned (read and
written in 16-byte vectors); each chunk is one launch over a table of its
leaves.  :func:`sgd_step`, :func:`prox_outer`, :func:`apply_scaled` and
:func:`apply_rows` are their one-leaf calls.

Each wrapper checks its inputs and raises on anything the kernel does not
take: a tensor off the card, a dtype other than f32/bf16 (int8 for the
quantized stack, f32 for weights and scales), a mismatched shape,
a non-contiguous layout.  It allocates the outputs with ``torch.empty`` (the
update is out of place, in the first operand's dtype), launches on PyTorch's
current stream, raises if a launch reports a CUDA error, and counts each
launch in :data:`LAUNCHES`.
There is no fallback: the plain versions in ``ref.py`` are for CPU tensors,
picked by ``ops.py``.
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
    lib.fu_max_leaves.argtypes = []
    lib.fu_max_leaves.restype = i32
    lib.fu_sub_scaled_leaves.argtypes = [p, i32, f32, i32, i32, p]
    lib.fu_sub_scaled_leaves.restype = i32
    lib.fu_prox_inner.argtypes = [p, p, p, p, f32, f32, i64, i32, i32, i32, p]
    lib.fu_prox_inner.restype = i32
    lib.fu_prox_outer_leaves.argtypes = [p, i32, f32, i32, i32, p]
    lib.fu_prox_outer_leaves.restype = i32
    lib.fu_apply_rows_leaves.argtypes = [p, i32, p, i64, i32, i32, p]
    lib.fu_apply_rows_leaves.restype = i32
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
    ``scalars`` (see :func:`_host_scalar`) and counts the launch."""
    (first, x), rest = args[0], args[1:]
    _check(name, first, x)
    for arg, t in rest:
        _check(name, arg, t, x.device)
        if t.shape != x.shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"{first} has {tuple(x.shape)}")
    scalars = [_host_scalar(name, s) for s in scalars]
    codes = [_code(name, arg, t) for arg, t in args]
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    ptrs = [t.data_ptr() for _, t in args]
    with torch.cuda.device(x.device):
        err = getattr(_lib(), f"fu_{name}")(
            out.data_ptr(), *ptrs, *scalars, n, *codes,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def prox_inner(theta: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
               eta_in: float, lam: float) -> torch.Tensor:
    """``θ − η_in·(g + λ·(θ − w))`` in f32, stored in ``theta.dtype``; one
    kernel launch."""
    return _elementwise("prox_inner", (("theta", theta), ("g", g), ("w", w)),
                        (eta_in, lam))


class Launch(NamedTuple):
    """One launch of a leaf-table kernel: its inputs' dtype codes, the
    indices of its leaves in the caller's list, in order, and the table the
    kernel reads, ``3 + len(codes)`` int64 words per leaf: the output
    pointer, the input pointers, the length and 1 if every one of the
    leaf's pointers is 16-byte aligned (its elements move in vectors)."""
    codes: Tuple[int, ...]
    leaves: Tuple[int, ...]
    words: array.array


def plan_launches(name: str, args, outs: Sequence[torch.Tensor],
                  max_leaves: int, rows: Optional[int] = None
                  ) -> List[Launch]:
    """The launches that compute the leaves ``outs[i]`` from the inputs
    ``args`` (``(arg name, list of leaves)`` pairs), checking each input
    on the way: on ``outs[0]``'s device, contiguous, f32 or bf16, of one
    shape with the leaf's other inputs (``outs[i]`` is allocated like the
    first); ``name`` heads the error.  With ``rows`` (M) the last input
    of each leaf is instead its stack, of shape ``[M, *shape]``, and the
    leaf's vector flag also needs the stack's row stride (the leaf's
    length times the stack's element size) to be a multiple of 16 bytes,
    so that every row is aligned and not only the first.  One launch per
    dtype combination of the inputs, in order of first appearance, and per
    chunk of at most ``max_leaves`` leaves.  Empty leaves need no launch
    and are left out; every other leaf is in exactly one launch, and the
    leaves keep their order within it."""
    if not outs:
        return []
    dev, tensor, codes_of = outs[0].get_device(), torch.Tensor, _DTYPE_CODES
    stack = len(args) - 1 if rows is not None else -1
    groups = {}
    for i, (out, *ins) in enumerate(zip(outs, *[ts for _, ts in args])):
        ptrs, low, codes, shape = [out.data_ptr()], 0, (), None
        n = out.numel()
        for k, t in enumerate(ins):
            if not (isinstance(t, tensor) and t.get_device() == dev
                    and t.is_contiguous()
                    and (code := codes_of.get(t.dtype)) is not None):
                _refuse_leaf(name, args, outs, i, rows)
            if k == stack:
                if t.shape[:1] != (rows,) or t.shape[1:] != shape:
                    _refuse_leaf(name, args, outs, i, rows)
                low |= n * t.element_size()
            elif shape is None:
                shape = t.shape
            elif t.shape != shape:
                _refuse_leaf(name, args, outs, i, rows)
            p = t.data_ptr()
            ptrs.append(p)
            low |= p
            codes += (code,)
        if n == 0:
            continue
        ptrs += (n, ((low | ptrs[0]) & 15) == 0)
        group = groups.get(codes)
        if group is None:
            groups[codes] = ([i], array.array("q", ptrs))
        else:
            group[0].append(i)
            group[1].extend(ptrs)
    width = 3 + len(args)
    return [Launch(codes, tuple(idx[c:c + max_leaves]),
                   words[width * c:width * (c + max_leaves)])
            for codes, (idx, words) in groups.items()
            for c in range(0, len(idx), max_leaves)]


def _refuse_leaf(name, args, outs, i, rows) -> None:
    """Raises what is wrong with leaf ``i`` of ``args``."""
    for k, (arg, ts) in enumerate(args):
        _check(name, f"{arg}[{i}]", ts[i], outs[0].device)
        _code(name, f"{arg}[{i}]", ts[i])
        want = outs[i].shape
        if rows is not None and k == len(args) - 1:
            want = (rows, *want)
        if ts[i].shape != want:
            raise ValueError(f"{name}: {arg}[{i}] has shape "
                             f"{tuple(ts[i].shape)}, expected {tuple(want)}")
    raise ValueError(f"{name}: leaf {i} is not on {outs[0].device}")


@functools.lru_cache(maxsize=None)
def max_leaves() -> int:
    """Leaves one launch of a leaf-table kernel takes (``kMaxLeaves`` of
    ``fused_update.cu``)."""
    return _lib().fu_max_leaves()


def _table_leaves(name: str, entry: str, args, scalars, rows=None,
                  others=()) -> List[torch.Tensor]:
    """The library's ``entry`` (a ``fu_*_leaves`` function) over every leaf
    of ``args`` (``(("w", ws), (.., bs))``): the outputs allocated like
    ``ws``, then one launch per :func:`plan_launches` entry (``rows`` as
    there), each counted under ``name``.  ``scalars`` are the C arguments
    between the leaf count and the dtype codes; ``others`` (``(arg name,
    tensor)`` pairs) are checked to be on ``ws[0]``'s card first."""
    (first, ws), (arg, bs) = args
    if len(bs) != len(ws):
        raise ValueError(f"{name}: {arg} has {len(bs)} leaves, {first} has "
                         f"{len(ws)}")
    if not ws:
        return []
    _check(name, f"{first}[0]", ws[0])
    for other, t in others:
        _check(name, other, t, ws[0].device)
    outs = [torch.empty_like(w) for w in ws]
    plan = plan_launches(name, args, outs, max_leaves(), rows)
    if not plan:
        return outs
    fn = getattr(_lib(), entry)
    dev = ws[0].get_device()
    with torch.cuda.device(dev):
        stream = torch._C._cuda_getCurrentRawStream(dev)
        for launch in plan:
            err = fn(launch.words.buffer_info()[0], len(launch.leaves),
                     *scalars, *launch.codes, stream)
            _raise_on(name, err)
            LAUNCHES[name] += 1
    return outs


def _host_scalar(name: str, c) -> float:
    """``c`` as a Python float.  It passes by value as a C float, so the
    launch never waits on the device to read it; a tensor is refused for
    that reason."""
    if isinstance(c, torch.Tensor):
        raise TypeError(f"{name}: the scalar must be a host number, not a "
                        f"tensor")
    return float(c)


def sgd_step_leaves(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                    eta: float) -> List[torch.Tensor]:
    """``w − η·g`` in f32 for every pair of leaves, stored in ``w.dtype``;
    one kernel launch per dtype pair and chunk of ``max_leaves()`` leaves."""
    return _table_leaves("sgd_step", "fu_sub_scaled_leaves",
                         (("w", ws), ("g", gs)),
                         (_host_scalar("sgd_step", eta),))


def prox_outer_leaves(ws: Sequence[torch.Tensor],
                      thetas: Sequence[torch.Tensor], eta: float,
                      lam: float) -> List[torch.Tensor]:
    """``w − (ηλ)·(w − θ)`` in f32 for every pair of leaves, stored in
    ``w.dtype``; one kernel launch per dtype pair and chunk of
    ``max_leaves()`` leaves.  ηλ is formed in double and rounded to f32
    once, as the reference's ``eta * lam * (w − θ)`` rounds it."""
    return _table_leaves("prox_outer", "fu_prox_outer_leaves",
                         (("w", ws), ("theta", thetas)),
                         (_host_scalar("prox_outer", eta * lam),))


def apply_scaled_leaves(ws: Sequence[torch.Tensor],
                        ds: Sequence[torch.Tensor], scale: float
                        ) -> List[torch.Tensor]:
    """``w − scale·d`` in f32 for every pair of leaves, stored in
    ``w.dtype``; one kernel launch per dtype pair and chunk of
    ``max_leaves()`` leaves.  ``scale`` is a host number passed by value."""
    return _table_leaves("apply_scaled", "fu_sub_scaled_leaves",
                         (("w", ws), ("d", ds)),
                         (_host_scalar("apply_scaled", scale),))


def apply_rows_leaves(ws: Sequence[torch.Tensor],
                      stacks: Sequence[torch.Tensor], weights: torch.Tensor
                      ) -> List[torch.Tensor]:
    """``w − Σᵢ weights[i]·stack[i]`` in f32 for every leaf ``w`` and its
    ``[M, *w.shape]`` stack, stored in ``w.dtype``; ``weights`` is the
    ``[M]`` float32 row-weight vector on the leaves' card, shared by every
    leaf.  One kernel launch per dtype pair and chunk of ``max_leaves()``
    leaves; M = 0 gives ``w``."""
    name = "apply_rows"
    if not (isinstance(weights, torch.Tensor) and weights.dim() == 1
            and weights.dtype == torch.float32):
        raise ValueError(f"{name}: weights must be a float32 tensor of shape "
                         f"(M,), got {getattr(weights, 'dtype', weights)} "
                         f"{tuple(getattr(weights, 'shape', ()))}")
    m = weights.shape[0]
    return _table_leaves(name, "fu_apply_rows_leaves",
                         (("w", ws), ("d_stack", stacks)),
                         (weights.data_ptr(), m), rows=m,
                         others=(("weights", weights),))


def sgd_step(w: torch.Tensor, g: torch.Tensor, eta: float) -> torch.Tensor:
    """:func:`sgd_step_leaves` of one leaf."""
    return sgd_step_leaves([w], [g], eta)[0]


def prox_outer(w: torch.Tensor, theta: torch.Tensor, eta: float,
               lam: float) -> torch.Tensor:
    """:func:`prox_outer_leaves` of one leaf."""
    return prox_outer_leaves([w], [theta], eta, lam)[0]


def apply_scaled(w: torch.Tensor, d: torch.Tensor, scale: float
                 ) -> torch.Tensor:
    """:func:`apply_scaled_leaves` of one leaf."""
    return apply_scaled_leaves([w], [d], scale)[0]


def apply_rows(w: torch.Tensor, d_stack: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """:func:`apply_rows_leaves` of one leaf."""
    return apply_rows_leaves([w], [d_stack], weights)[0]


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
