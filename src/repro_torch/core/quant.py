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

The window apply never dequantizes a bank: ``core.server.apply_admitted_rows``
hands a :class:`QuantStack` to the ``apply_rows_q`` kernel.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


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


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row absmax/127 over all trailing axes; shape ``[capacity]``."""
    a = x.float().abs()
    absmax = a.amax(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else a
    return _div127(absmax)


def _bcast(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape(tuple(scale.shape) + (1,) * (ndim - scale.dim()))


def _q(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(x32 / safe), -127, 127).to(torch.int8)


def quantize_stack(tree) -> QuantStack:
    """``[capacity, ...]`` stacked tree → :class:`QuantStack`."""
    scales = tree_map(_row_scale, tree)
    q = tree_map(lambda x, s: _q(x.float(), _bcast(s, x.dim())), tree,
                 scales)
    return QuantStack(q, scales)


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


def _fma_err(a: torch.Tensor, q: torch.Tensor, s: torch.Tensor):
    # a − q·s rounded once, as XLA computes it (it contracts the product
    # into an FMA): q·s is exact in f64 (8 + 24 significant bits), so the
    # f64 difference rounded to f32 is the FMA's result unless that
    # difference itself rounded onto an f32 tie (a second rounding)
    return (a.double() - q.double() * _bcast(s, q.dim()).double()).float()


def _ef_body(adj):
    qstack = quantize_stack(adj)
    err = tree_map(_fma_err, adj, qstack.q, qstack.scales)
    return qstack, quantize_stack(err)


def ef_quantize_stack(raw, residual=None):
    """One error-feedback quantization step over a stacked buffer.

    ``adj = raw + residual`` per row (``residual`` is the carried
    quantization error of each row's user, zeros where absent; None for
    none at all); ``adj`` is quantized and the new error ``adj − dequant``
    is itself quantized for storage.  Returns ``(delta QuantStack, residual
    QuantStack)``.
    """
    if residual is None:
        return _ef_body(tree_map(lambda x: x.float(), raw))
    return _ef_body(tree_map(lambda x, r: x.float() + r, raw, residual))


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
        """Dequantized f32 ``[len(rows), ...]`` gather on the device."""
        idx = _index(rows, tree_leaves(self.stacked.q)[0].device)
        return tree_map(
            lambda q, s: _take(q, idx).float() * _bcast(_take(s, idx),
                                                       q.dim()),
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
