"""Symmetric int8 absmax quantization for delta banking, with error
feedback, as in ``src/repro/core/quant.py``.

Per ROW per LEAF for stacked bank buffers (:class:`QuantStack`), per LEAF
for retained snapshots (:class:`QuantTree`)::

    scale = absmax / 127          (0 for an all-zero row: dequant is exact)
    q     = clip(round(x / scale), -127, 127)  int8
    deq   = scale * q                          f32

Rounding follows the reference as XLA executes it: ``torch.round`` rounds
half to even as ``jnp.round`` does; ``x`` is divided by the scale (never
multiplied by its reciprocal), so the codes are the reference's wherever
both divisions round alike; and the scale is ``absmax × f32(1/127)``,
because XLA rewrites the reference's division by the constant 127 into that
product (a true division differs in the last bit on some rows).  :func:`ef_quantize_stack` is the error-feedback step: a user's
quantization error is banked as an int8 residual and added to the user's
next delta before it is quantized.

Handles the serving stack consumes:

  * :class:`QuantizedBank` -- the DeltaBank surface the ring needs
    (``stacked`` / ``capacity`` / ``k``) over a :class:`QuantStack`, with no
    host-materializing path: ``rows`` is a dequantizing gather on the
    device;
  * :class:`QuantizedHeads` -- a lazy head bank, ``head = snapshot −
    scale·q`` per gather, so int8 serving stores no fp32 head bank.

On a mesh (the sharded server) a :class:`QuantStack`'s codes are placed as
the fp32 bank's rows were and its scales split over "cohort"; both handles
then gather a row whole from the rank that owns it, with the same
arithmetic, so the bits do not depend on the layout.

The window apply never dequantizes a bank: ``core.server.apply_admitted_rows``
hands a :class:`QuantStack` to the ``apply_rows_q`` kernel.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.sharding.ctx import gather, is_sharded, take_row
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class QuantStack(NamedTuple):
    """Quantized stacked bank buffer: int8 rows + per-row-per-leaf scales."""
    q: Any        # int8 tree, leaves [capacity, ...]
    scales: Any   # f32 tree, leaves [capacity]


class QuantTree(NamedTuple):
    """Quantized params(-subset) tree: int8 leaves + one scale per leaf."""
    q: Any        # int8 tree, param-shaped
    scales: Any   # f32 tree, a 0-d tensor per leaf


def _div127(absmax: torch.Tensor) -> torch.Tensor:
    # absmax / 127 as XLA computes it: times the f32 reciprocal
    return absmax * torch.tensor(1.0 / 127.0, dtype=torch.float32,
                                 device=absmax.device)


def _bcast(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape(tuple(scale.shape) + (1,) * (ndim - scale.dim()))


def _q(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(x32 / safe), -127, 127).to(torch.int8)


# elements of a stacked leaf that the stack quantizer takes at a time: its
# f32/f64 temporaries stay near 0.25-0.5 GB each however large the bank (4
# rows of gemma2-2b's unembedding are 9.4 GB in f32, and whole-stack
# temporaries of that size ran an 80 GB card out of memory)
_BLOCK_ELEMS = 1 << 26


def _fma_err(a, q, s):
    # a − q·s rounded once, as XLA computes it (it contracts the product
    # into an FMA): q·s is exact in f64 (8 + 24 significant bits), so the
    # f64 difference rounded to f32 is the FMA's result unless that
    # difference itself rounded onto an f32 tie (a second rounding)
    return (a.double() - q.double() * s.double()).float()


def _quantize_rows(x: torch.Tensor, r=None, err: bool = False):
    """One stacked leaf ``x`` ``[M, ...]`` (plus the residual ``r`` of its
    shape) → int8 codes, ``[M]`` scales and, with ``err``, the f32 error
    ``adj − q·scale`` as XLA's FMA rounds it, where ``adj = x + r``.

    Works in column blocks of at most _BLOCK_ELEMS elements and forms
    ``adj`` block by block (once for the row absmax, once for the codes),
    so no temporary spans the whole stack.  Every step is elementwise or a
    max, so the numbers are those of one pass over the stack."""
    M = x.shape[0]
    x2 = x.reshape(M, -1)
    r2 = None if r is None else r.reshape(x2.shape)
    step = max(1, _BLOCK_ELEMS // max(M, 1))
    blocks = [slice(j, j + step) for j in range(0, x2.shape[1], step)]

    def adj(b):
        a = x2[:, b].float()
        return a if r2 is None else a + r2[:, b]
    scale = _div127(torch.stack([adj(b).abs().amax(dim=1)
                                 for b in blocks]).amax(dim=0))
    s2 = scale[:, None]
    q = torch.empty(x2.shape, dtype=torch.int8, device=x.device)
    e = torch.empty(x2.shape, dtype=torch.float32, device=x.device) \
        if err else None
    for b in blocks:
        a = adj(b)
        q[:, b] = _q(a, s2)
        if err:
            e[:, b] = _fma_err(a, q[:, b], s2)
    if err:
        return q.reshape(x.shape), scale, e.reshape(x.shape)
    return q.reshape(x.shape), scale


def quantize_stack(tree) -> QuantStack:
    """``[capacity, ...]`` stacked tree → :class:`QuantStack`."""
    parts = [_quantize_rows(x) for x in tree_leaves(tree)]
    return QuantStack(tree_unflatten(tree, [q for q, _ in parts]),
                      tree_unflatten(tree, [s for _, s in parts]))


def dequantize_stack(qstack: QuantStack):
    """:class:`QuantStack` → f32 stacked tree (scale·q per row)."""
    return tree_map(lambda q, s: q.float() * _bcast(s, q.dim()),
                    qstack.q, qstack.scales)


def quantize_tree(tree) -> QuantTree:
    """Params(-subset) tree → :class:`QuantTree` (one scale per leaf); the
    ring demotes closed windows' snapshots with it."""
    scales = tree_map(lambda x: _div127(x.float().abs().max()), tree)
    q = tree_map(lambda x, s: _q(x.float(), s), tree, scales)
    return QuantTree(q, scales)


def dequantize_tree(qtree: QuantTree):
    return tree_map(lambda q, s: q.float() * s, qtree.q, qtree.scales)


def ef_quantize_stack(raw, residual=None):
    """One error-feedback quantization step over a stacked buffer.

    ``adj = raw + residual`` per row (``residual`` is the carried
    quantization error of each row's user, zeros where absent; None for
    none at all); ``adj`` is quantized and the new error ``adj − dequant``
    is itself quantized for storage.  Returns ``(delta QuantStack, residual
    QuantStack)``.
    """
    xs = tree_leaves(raw)
    rs = tree_leaves(residual) if residual is not None else [None] * len(xs)
    delta, res = [], []
    for x, r in zip(xs, rs):
        q, scale, e = _quantize_rows(x, r, err=True)
        delta.append((q, scale))
        res.append(_quantize_rows(e))
        del e
    return tuple(QuantStack(tree_unflatten(raw, [q for q, _ in parts]),
                            tree_unflatten(raw, [s for _, s in parts]))
                 for parts in (delta, res))


def _stack_rows(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _take(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, rows)


def _index(rows, device) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.long).to(device)


class QuantizedBank:
    """DeltaBank-shaped handle over a :class:`QuantStack`: ``stacked``,
    ``capacity``, ``k``, and no host-materializing ``row`` path, so
    ``host_materializations`` cannot move."""

    def __init__(self, qstack: QuantStack, k: int):
        self.stacked = qstack
        self.k = k

    @property
    def capacity(self) -> int:
        return tree_leaves(self.stacked.q)[0].shape[0]

    def __len__(self) -> int:
        return self.k

    def rows(self, rows):
        """Dequantized f32 ``[len(rows), ...]`` gather on the device.  A
        stack placed on a mesh gives each row whole, from the rank that
        owns it (a collective, see :mod:`repro_torch.sharding.ctx`)."""
        if is_sharded(tree_leaves(self.stacked.q)[0]):
            return _stack_rows([tree_map(
                lambda q, s: gather(take_row(q, r)).float()
                * gather(take_row(s, r)), self.stacked.q,
                self.stacked.scales) for r in rows])
        idx = _index(rows, tree_leaves(self.stacked.q)[0].device)
        # one f32 temporary a leaf: the product is taken in place
        return tree_map(
            lambda q, s: _take(q, idx).float().mul_(_bcast(_take(s, idx),
                                                           q.dim())),
            self.stacked.q, self.stacked.scales)

    def row(self, i: int):
        return tree_map(lambda x: x[0], self.rows([int(i)]))


class QuantizedHeads:
    """Lazy quantized head bank: ``head_row = snapshot − scale·q``, computed
    in f32 per gather and stored in the param dtype.  Holds a reference to
    the flush's snapshot tree and its :class:`QuantizedBank`, nothing
    else."""

    def __init__(self, snapshot, qbank: QuantizedBank):
        self.snapshot = snapshot
        self.qbank = qbank

    @property
    def k(self) -> int:
        return self.qbank.k

    def rows(self, rows):
        st = self.qbank.stacked
        if is_sharded(tree_leaves(st.q)[0]):
            d = self.qbank.rows(rows)
            return tree_map(lambda p, dd: (gather(p)[None].float() - dd).to(
                p.dtype), self.snapshot, d)
        idx = _index(rows, tree_leaves(st.q)[0].device)

        def one(p, q, s):
            d = _take(q, idx).float() * _bcast(_take(s, idx), q.dim())
            return (p[None].float() - d).to(p.dtype)
        return tree_map(one, self.snapshot, st.q, st.scales)

    def row(self, i: int):
        return tree_map(lambda x: x[0], self.rows([int(i)]))


def fp32_row_nbytes(qstack: QuantStack) -> int:
    """Bytes ONE row of this stack would take as fp32 (scales excluded):
    the baseline of ``ring_bytes_per_user_fp32``."""
    return sum(4 * math.prod(x.shape[1:]) for x in tree_leaves(qstack.q))
