"""Hopper kernels for the local steps and the server apply, bound through
ctypes.

  * :func:`sgd_step_leaves` -- ``w ← w − η·g`` over a list of leaves;
    replaces the TPU kernel ``src/repro/kernels/fused_update/kernel.py:78``
    (``sgd_step``).
  * :func:`prox_inner_leaves` -- ``θ ← θ − η_in·(g + λ·(θ − w))`` over a
    list of leaves; replaces ``kernel.py:83`` (``prox_inner``).
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
  * :func:`apply_rows_q_leaves` -- ``w ← w − Σᵢ (sᵢ·scaleᵢ)·qᵢ`` over a list
    of leaves, their int8 ``[M, *w.shape]`` stacks and their ``[M]`` f32
    row scales; replaces ``kernel.py:186`` (``apply_rows_q``).  Every window
    apply of a server that banks deltas in int8 runs it once per param
    tree.

All six are CUDA C++ for ``sm_90a`` in ``repro_torch/csrc/fused_update.cu``,
built by :mod:`repro_torch.kernels._build` at first use.  All are
memory-bound: their bound on the card is the bytes they move (``2n`` reads and
``n`` writes -- ``3n`` reads for ``prox_inner`` -- or ``(M+1)·n`` reads and
``n`` writes, times the element size; for ``apply_rows_q`` ``M·n`` int8
bytes, ``w`` read and written, and ``4M`` bytes of scales per leaf and of
weights) over 3.35 TB/s; the source notes say what the design does about it.

Every wrapper launches once per tree: :func:`plan_launches` groups the
leaves by the dtypes of their inputs, drops empty ones, cuts each group into
chunks of at most ``fu_max_leaves()`` leaves and flags the leaves whose
pointers (and, for a stack, whose every row) are 16-byte aligned (read and
written in 16-byte vectors); each chunk is one launch over a table of its
leaves.  :func:`sgd_step`, :func:`prox_inner`, :func:`prox_outer`,
:func:`apply_scaled`, :func:`apply_rows` and :func:`apply_rows_q` are their
one-leaf calls.

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
# a stack followed by its row scales may also hold int8 codes (apply_rows_q)
_INT8 = 2
_CODES_STACK = {**_DTYPE_CODES, torch.int8: _INT8}


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
    lib.fu_prox_inner_leaves.argtypes = [p, i32, f32, f32, i32, i32, i32, p]
    lib.fu_prox_inner_leaves.restype = i32
    lib.fu_prox_outer_leaves.argtypes = [p, i32, f32, i32, i32, p]
    lib.fu_prox_outer_leaves.restype = i32
    lib.fu_apply_rows_leaves.argtypes = [p, i32, p, i64, i32, i32, p]
    lib.fu_apply_rows_leaves.restype = i32
    lib.fu_apply_rows_q_leaves.argtypes = [p, i32, p, i64, i32, p]
    lib.fu_apply_rows_q_leaves.restype = i32
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


def _raise_on(name: str, err: int) -> None:
    if err:
        msg = _lib().fu_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} ({msg})")


class Launch(NamedTuple):
    """One launch of a leaf-table kernel: its inputs' dtype codes, the
    indices of its leaves in the caller's list, in order, and the table the
    kernel reads, ``3 + len(codes)`` int64 words per leaf: the output
    pointer, the input pointers, the length and 1 if the leaf's elements
    move in 16-byte vectors."""
    codes: Tuple[int, ...]
    leaves: Tuple[int, ...]
    words: array.array


def plan_launches(name: str, args, outs: Sequence[torch.Tensor],
                  max_leaves: int, rows: Optional[int] = None
                  ) -> List[Launch]:
    """The launches that compute the leaves ``outs[i]`` from the inputs
    ``args`` (``(arg name, list of leaves)`` pairs), checking each input
    on the way: on ``outs[0]``'s device, contiguous, f32 or bf16, of the
    shape of ``outs[i]`` (which is allocated like the first input); ``name``
    heads the error.  A leaf's vector flag is set if all its pointers are
    16-byte aligned.  With ``rows`` (M) the second input of each leaf is
    instead its stack, of shape ``[M, *shape]``, and every input after it a
    float32 vector of shape ``[M]``, the leaf's own row scales, which the
    kernel reads one scalar at a time and whose alignment does not matter.
    A stack is f32 or bf16, or int8 where scales follow it
    (``apply_rows_q``).  The vector flag of an f32 or bf16 stack's leaf also
    needs the stack's row stride (the leaf's length times the element size)
    to be a multiple of 16 bytes, so that every row is aligned and not only
    the first; an int8 stack does not count (the kernel reads its rows as
    aligned words and shifts the codes into place).  One launch per dtype
    combination
    of the inputs, in order of first appearance, and per chunk of at most
    ``max_leaves`` leaves.  Empty leaves need no launch and are left out;
    every other leaf is in exactly one launch, and the leaves keep their
    order within it."""
    if not outs:
        return []
    dev, tensor, f32 = outs[0].get_device(), torch.Tensor, torch.float32
    stack = 1 if rows is not None else len(args)
    stack_codes = _CODES_STACK if len(args) > 2 else _DTYPE_CODES
    groups = {}
    for i, (out, *ins) in enumerate(zip(outs, *[ts for _, ts in args])):
        ptrs, shape, codes = [out.data_ptr()], out.shape, ()
        low, n = ptrs[0], out.numel()
        for k, t in enumerate(ins):
            if not (isinstance(t, tensor) and t.get_device() == dev
                    and t.is_contiguous()):
                _refuse_leaf(name, args, outs, i, rows)
            p = t.data_ptr()
            if k < stack:
                code = _DTYPE_CODES.get(t.dtype)
                if code is None or t.shape != shape:
                    _refuse_leaf(name, args, outs, i, rows)
                low |= p
            elif k == stack:
                code = stack_codes.get(t.dtype)
                if (code is None or t.shape[:1] != (rows,)
                        or t.shape[1:] != shape):
                    _refuse_leaf(name, args, outs, i, rows)
                if code != _INT8:
                    low |= p | n * t.element_size()
            else:
                code = 0
                if t.dtype != f32 or t.shape != (rows,):
                    _refuse_leaf(name, args, outs, i, rows)
            ptrs.append(p)
            codes += (code,)
        if n == 0:
            continue
        ptrs += (n, (low & 15) == 0)
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


_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8"}


def _refuse_leaf(name, args, outs, i, rows) -> None:
    """Raises what is wrong with leaf ``i`` of ``args``: first a type, dtype
    or shape, then a device or layout."""
    for k, (arg, ts) in enumerate(args):
        t = ts[i]
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg}[{i}] must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        want, dtypes = outs[i].shape, _DTYPE_CODES
        if rows is not None and k == 1:
            want = (rows, *want)
            dtypes = _CODES_STACK if len(args) > 2 else _DTYPE_CODES
        elif rows is not None and k > 1:
            want, dtypes = (rows,), (torch.float32,)
        if t.dtype not in dtypes:
            takes = " or ".join(_DTYPE_NAMES[d] for d in dtypes)
            raise TypeError(f"{name}: {arg}[{i}] has dtype {t.dtype}; the "
                            f"kernel takes {takes}")
        if t.shape != want:
            raise ValueError(f"{name}: {arg}[{i}] has shape "
                             f"{tuple(t.shape)}, expected {tuple(want)}")
    for arg, ts in args:
        _check(name, f"{arg}[{i}]", ts[i], outs[0].device)
    raise ValueError(f"{name}: leaf {i} is not on {outs[0].device}")


@functools.lru_cache(maxsize=None)
def max_leaves() -> int:
    """Leaves one launch of a leaf-table kernel takes (``kMaxLeaves`` of
    ``fused_update.cu``)."""
    return _lib().fu_max_leaves()


def _table_leaves(name: str, entry: str, args, scalars, rows=None,
                  others=(), n_codes=None) -> List[torch.Tensor]:
    """The library's ``entry`` (a ``fu_*_leaves`` function) over every leaf
    of ``args`` (``(("w", ws), (.., bs), ...)``): the outputs allocated like
    ``ws``, then one launch per :func:`plan_launches` entry (``rows`` as
    there), each counted under ``name``.  ``scalars`` are the C arguments
    between the leaf count and the dtype codes, of which the entry takes the
    first ``n_codes`` (all by default); ``others`` (``(arg name, tensor)``
    pairs) are checked to be on ``ws[0]``'s card first."""
    (first, ws), *rest = args
    for arg, bs in rest:
        if len(bs) != len(ws):
            raise ValueError(f"{name}: {arg} has {len(bs)} leaves, {first} "
                             f"has {len(ws)}")
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
                     *scalars, *launch.codes[:n_codes], stream)
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


def prox_inner_leaves(thetas: Sequence[torch.Tensor],
                      gs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                      eta_in: float, lam: float) -> List[torch.Tensor]:
    """``θ − η_in·(g + λ·(θ − w))`` in f32 for every triple of leaves,
    stored in ``theta.dtype``; one kernel launch per dtype triple and chunk
    of ``max_leaves()`` leaves.  η_in and λ are each rounded to f32, as the
    reference rounds them."""
    name = "prox_inner"
    return _table_leaves(name, "fu_prox_inner_leaves",
                         (("theta", thetas), ("g", gs), ("w", ws)),
                         (_host_scalar(name, eta_in),
                          _host_scalar(name, lam)))


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


def _row_count(name: str, weights: torch.Tensor) -> int:
    """M of the ``[M]`` float32 row-weight vector ``weights``."""
    if not (isinstance(weights, torch.Tensor) and weights.dim() == 1
            and weights.dtype == torch.float32):
        raise ValueError(f"{name}: weights must be a float32 tensor of shape "
                         f"(M,), got {getattr(weights, 'dtype', weights)} "
                         f"{tuple(getattr(weights, 'shape', ()))}")
    return weights.shape[0]


def apply_rows_leaves(ws: Sequence[torch.Tensor],
                      stacks: Sequence[torch.Tensor], weights: torch.Tensor
                      ) -> List[torch.Tensor]:
    """``w − Σᵢ weights[i]·stack[i]`` in f32 for every leaf ``w`` and its
    ``[M, *w.shape]`` f32 or bf16 stack, stored in ``w.dtype``; ``weights``
    is the ``[M]`` float32 row-weight vector on the leaves' card, shared by
    every leaf.  One kernel launch per dtype pair and chunk of
    ``max_leaves()`` leaves; M = 0 gives ``w``."""
    name = "apply_rows"
    m = _row_count(name, weights)
    return _table_leaves(name, "fu_apply_rows_leaves",
                         (("w", ws), ("d_stack", stacks)),
                         (weights.data_ptr(), m), rows=m,
                         others=(("weights", weights),))


def apply_rows_q_leaves(ws: Sequence[torch.Tensor],
                        q_stacks: Sequence[torch.Tensor],
                        scales: Sequence[torch.Tensor], weights: torch.Tensor
                        ) -> List[torch.Tensor]:
    """``w − Σᵢ (weights[i]·scales[i])·float(q_stack[i])`` in f32 for every
    leaf ``w``, its int8 ``[M, *w.shape]`` stack and its ``[M]`` float32 row
    scales (a :class:`QuantStack`'s leaves), stored in ``w.dtype``;
    ``weights`` is the ``[M]`` float32 row-weight vector on the leaves'
    card, shared by every leaf.  One kernel launch per dtype of ``w`` and
    chunk of ``max_leaves()`` leaves; M = 0 gives ``w``."""
    name = "apply_rows_q"
    m = _row_count(name, weights)
    return _table_leaves(name, "fu_apply_rows_q_leaves",
                         (("w", ws), ("q_stack", q_stacks),
                          ("scales", scales)),
                         (weights.data_ptr(), m), rows=m,
                         others=(("weights", weights),), n_codes=1)


def sgd_step(w: torch.Tensor, g: torch.Tensor, eta: float) -> torch.Tensor:
    """:func:`sgd_step_leaves` of one leaf."""
    return sgd_step_leaves([w], [g], eta)[0]


def prox_inner(theta: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
               eta_in: float, lam: float) -> torch.Tensor:
    """:func:`prox_inner_leaves` of one leaf."""
    return prox_inner_leaves([theta], [g], [w], eta_in, lam)[0]


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
    """:func:`apply_rows_q_leaves` of one leaf."""
    return apply_rows_q_leaves([w], [q_stack], [scales], weights)[0]
