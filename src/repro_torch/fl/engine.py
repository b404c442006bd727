"""Vectorized cohort execution engine with an on-device DeltaBank, as in
``src/repro/fl/engine.py``.

Between two server applies the global params are frozen, so every client
whose compute window falls in that interval sees the same weights and their
Q-step local updates are independent.  :class:`CohortEngine` runs such a
cohort in one call: ``torch.func.vmap`` over clients (the default on the
card), or a Python loop over them (``"map"``, the default on the CPU).
Cohorts are padded up to power-of-two buckets, as in the reference, so a
bank's capacity takes O(log max_cohort) values; ``padding_waste`` counts the
padding rows computed.

DeltaBank contract:

  * ``update_cohort`` returns a :class:`DeltaBank`: a handle to the stacked
    ``[bucket, ...]`` per-client delta buffer, which stays on the device.
  * Bulk consumers (buffered/sync applies) read ``bank.stacked`` and reduce
    it on the device through ``apply_rows`` with a per-row weight vector, so
    no per-client delta crosses to the host.
  * Row consumers (the immediate apply) call ``bank.row(i)``: the first
    access copies the whole stack to the host once (counted in
    ``stats["host_materializations"]``) and every row after that is a host
    view.

A strategy with ``personal_subset`` set returns deltas in the pruned subset
structure (:mod:`repro_torch.core.subset`), and the bank's stacked buffer
carries only the personal leaves.  Every bank goes through the callbacks
registered with :meth:`CohortEngine.add_bank_hook` before ``update_cohort``
returns it: the serving ring retains banks across windows that way.

Stateful strategies (SCAFFOLD's control variates) pass one client-state
tree per client to ``update_cohort(..., cstate_list=...)``: the states are
stacked on the device along the cohort axis and mapped with the batches,
the strategy's shared state (SCAFFOLD's c_global) passes unbatched, and the
updated states come back on the bank (:meth:`DeltaBank.client_state`, a
gather on the device).

The per-event sequential path is kept behind ``vectorized=False``.

``cohort_impl="shard_map"`` (the reference's name) splits the cohort over
the "cohort" axis of a ``torch.distributed`` ``DeviceMesh``, one process per
device (:mod:`repro_torch.sharding.ctx`).  Every rank runs the same program
with the same batch list; each computes the rows of its own cohort slice
one at a time, as the reference's ``lax.map`` (so a row's bits do not
depend on how many rows its rank holds), against params gathered whole
(model-replicated compute).  The delta stack is stored as a DTensor: rows
split over "cohort" and, given ``param_shardings``, each row's model dims
as its param's (a pure placement, bits unchanged; a personal-subset delta
tree stays cohort-split only).  Bulk consumers reduce such a bank with the
sequential apply; ``row()`` gathers the whole stack to the host once and
counts one host materialization, as the reference does.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.convert import to_tensor
from repro_torch.core import client_update, split_batches_for_option
from repro_torch.core.types import PersAFLConfig
from repro_torch.device import resolve_device
from repro_torch.sharding import ctx
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _stack(trees: List):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


class DeltaBank:
    """Handle to a stacked ``[capacity, ...]`` per-client delta buffer.

    ``stacked`` is the device buffer (rows ≥ ``k`` are bucket padding);
    rows cross to the host only through :meth:`row` — one copy of the whole
    stack on first access, host views afterwards.  Iterating yields the
    ``k`` real rows in cohort order.
    """

    def __init__(self, stacked=None, k: int = 0,
                 stats: Optional[Dict] = None, rows: Optional[List] = None,
                 cstates=None, cstate_rows: Optional[List] = None):
        self._stacked = stacked
        self._rows = rows          # per-event path: one delta tree per row
        self.k = k if rows is None else len(rows)
        self._stats = stats if stats is not None else {}
        self._host = None
        # stateful-strategy runs: the updated per-client states, stacked
        # along the same cohort axis (or one tree per row, per-event path)
        self._cstates = cstates
        self._cstate_rows = cstate_rows
        self._device = None if stacked is None \
            else tree_leaves(stacked)[0].device
        # a sharded stack's placements, to store it again after row()
        # released it
        self._layout = None if stacked is None else tree_map(
            lambda x: (x.device_mesh, x.placements)
            if ctx.is_sharded(x) else None, stacked)

    @property
    def capacity(self) -> int:
        if self._rows is not None:
            return self.k
        tree = self._stacked if self._stacked is not None else self._host
        return tree_leaves(tree)[0].shape[0]

    @property
    def stacked(self):
        """The ``[capacity, ...]`` device buffer (stacked lazily when the
        bank was built from per-event rows; copied back if host
        materialization already released the device copy)."""
        if self._stacked is None:
            if self._rows is not None:
                self._stacked = _stack(self._rows)
            else:
                self._stacked = tree_map(
                    lambda x, lay: x.to(self._device) if lay is None
                    else ctx.place_full(x.to(self._device), *lay),
                    self._host, self._layout)
        return self._stacked

    def row(self, i: int):
        """Materialize row ``i`` on the host (lazy, whole-stack-at-once)."""
        if self._rows is not None:
            return self._rows[i]
        if self._host is None:
            self._stats["host_materializations"] = \
                self._stats.get("host_materializations", 0) + 1
            # a sharded stack is gathered whole from its owners first
            self._host = tree_map(lambda x: x.cpu(),
                                  ctx.gather(self._stacked))
            # release the device buffer — rows serve from host views now,
            # and holding both copies would double delta residency
            self._stacked = None
        return tree_map(lambda x: x[i], self._host)

    def client_state(self, i: int):
        """Row ``i``'s updated client state (stateful strategies only): a
        gather from the stacked state buffer on its device, never a host
        copy.  The row is copied out so that it does not keep the whole
        stack alive; a sharded stack's row comes from the rank that owns
        it, whole on every rank (a collective: every rank asks for the same
        rows in the same order)."""
        if self._cstate_rows is not None:
            return self._cstate_rows[i]
        if self._cstates is None:
            raise ValueError("bank carries no client states "
                             "(stateless strategy)")
        return tree_map(lambda x: ctx.gather(ctx.take_row(x, i))
                        if ctx.is_sharded(x) else x[i].clone(),
                        self._cstates)

    def __len__(self) -> int:
        return self.k

    def __getitem__(self, i: int):
        if not -self.k <= i < self.k:
            raise IndexError(i)
        return self.row(i % self.k)

    def __iter__(self):
        return (self.row(i) for i in range(self.k))


class CohortEngine:
    """Batched ``client_update`` over a cohort of clients on ``device``.

    ``cohort_impl`` picks how the cohort axis is mapped:
      * ``"vmap"`` — ``torch.func.vmap`` over clients: the whole cohort's
        local updates run as one batched computation (default on CUDA).
      * ``"map"``  — a Python loop over the cohort's rows, stacked after
        (default on the CPU).
      * ``"shard_map"`` — the cohort split over the mesh's "cohort" axis,
        each rank looping over its own rows (see the module docstring);
        buckets round up to a multiple of the cohort-axis size.
    All are the same math.  ``strategy`` is a bound
    :class:`repro_torch.fl.api.Strategy` whose ``local_update`` replaces the
    built-in Algorithm-2 ``client_update``.

    ``mesh`` (shard_map only) is a 1-D ``("cohort",)`` or 2-D ``("cohort",
    "model")`` ``DeviceMesh`` (:func:`repro_torch.sharding.ctx.
    cohort_model_mesh`); without one, the :func:`use_mesh` context's, else
    the memoized 1-D mesh.  ``param_shardings`` is a params-shaped tree of
    :class:`repro_torch.sharding.rules.NamedSharding` on ``mesh``: the
    placement of each bank row's model dims.  ``device`` is
    the rank's device.
    """

    def __init__(self, pcfg: PersAFLConfig, loss_fn: Callable, *,
                 vectorized: bool = True, cohort_impl: str = "auto",
                 strategy=None, device="cuda", mesh=None,
                 param_shardings=None):
        self.device = resolve_device(device)
        self.pcfg = pcfg
        self.loss_fn = loss_fn
        self.vectorized = vectorized
        if cohort_impl == "auto":
            cohort_impl = "vmap" if self.device.type == "cuda" else "map"
        if cohort_impl not in ("vmap", "map", "shard_map"):
            raise ValueError(
                f"cohort_impl must be 'auto', 'vmap', 'map' or 'shard_map', "
                f"got {cohort_impl!r}")
        self.cohort_impl = cohort_impl
        # _ndev is the COHORT-AXIS size: it drives bucket rounding and the
        # batcher's user -> cohort-slice keying
        self._ndev = 1
        self._mesh = None
        self._param_shardings = None
        if cohort_impl == "shard_map":
            self._mesh = mesh if mesh is not None \
                else (ctx.active_mesh() or ctx.cohort_mesh())
            if "cohort" not in self._mesh.mesh_dim_names:
                raise ValueError(
                    f"cohort_impl='shard_map' needs a mesh with a 'cohort' "
                    f"axis, got axes {self._mesh.mesh_dim_names}; build one "
                    f"with repro_torch.sharding.ctx.cohort_model_mesh()")
            self._ndev = ctx.cohort_axis_size(self._mesh)
            self._param_shardings = param_shardings
        self.stats: Dict[str, int] = {"cohort_calls": 0, "clients": 0,
                                      "max_cohort": 0, "padding_waste": 0,
                                      "host_materializations": 0}
        self.strategy = strategy
        self.stateful = bool(strategy is not None
                             and getattr(strategy, "stateful", False))
        if strategy is not None:
            def _one(params, batches):
                delta, _, _ = strategy.local_update(params, batches, None)
                return delta

            def _one_s(params, batches, cstate, shared):
                # the shared state (SCAFFOLD's c_global) is a separate
                # unbatched input, recombined with the client's state row
                # inside the mapped body
                delta, new_cstate, _ = strategy.local_update(
                    params, batches, strategy.assemble_state(cstate, shared))
                return delta, new_cstate
        else:
            def _one(params, batches_3q):
                batches = split_batches_for_option(pcfg.option, batches_3q)
                delta, _ = client_update(pcfg, loss_fn, params, batches)
                return delta
            _one_s = None
        self._one = _one
        self._one_s = _one_s
        # window-boundary hooks: every bank this engine produces is handed
        # to each callback before update_cohort returns it
        self._bank_hooks: List[Callable[[DeltaBank], None]] = []

    def place_params(self, params):
        """``params`` (whole, the same on every rank) stored as the engine's
        ``param_shardings`` place them; unchanged without shardings."""
        if self._param_shardings is None:
            return params
        return tree_map(lambda x, sh: ctx.place_full(x, self._mesh,
                                                     sh.placements),
                        params, self._param_shardings)

    def add_bank_hook(self, fn: Callable[["DeltaBank"], None]) -> None:
        """Register a bank-handoff callback (the serving ring's retention).
        Called once per ``update_cohort`` with the new bank."""
        self._bank_hooks.append(fn)

    def _emit(self, bank: DeltaBank) -> DeltaBank:
        for hook in self._bank_hooks:
            hook(bank)
        return bank

    @staticmethod
    def _vmap(fn, in_dims, *args):
        """``fn`` over the cohort through ``torch.func.vmap``; ``fn`` returns
        a tuple of trees.  vmap returns tensors only, so each tree goes out
        as its list of leaves and comes back in its own structure (a pruned
        subset tree holds ``None``)."""
        templates = []

        def flat(*a):
            trees = fn(*a)
            templates.append([tree_map(lambda _: 0, t) for t in trees])
            return [tree_leaves(t) for t in trees]
        outs = vmap(flat, in_dims=in_dims)(*args)
        # vmap may hand the cohort axis back as a strided view; the apply
        # kernels take contiguous rows
        return [tree_unflatten(t, [x.contiguous() for x in leaves])
                for t, leaves in zip(templates[0], outs)]

    def _bucket(self, k: int) -> int:
        """Pow2 bucket of a k-client cohort, rounded up to a multiple of the
        cohort-axis size when the cohort is split (every slice gets equal
        rows; on the 2-D mesh a slice is a model-parallel group, so a 2×4
        mesh rounds to multiples of 2)."""
        if self._ndev > 1:
            per = -(-k // self._ndev)
            return self._ndev * (1 << max(per - 1, 0).bit_length())
        return 1 << max(k - 1, 0).bit_length()

    def _to_device(self, host_tree):
        return tree_map(lambda x: to_tensor(x, self.device), host_tree)

    def _pad(self, items: List, bucket: int) -> List:
        """``items`` padded to ``bucket`` by repeating the last one."""
        return list(items) + [items[-1]] * (bucket - len(items))

    def _pad_stack(self, batch_list: List, cstate_list: Optional[List],
                   rows: Optional[slice] = None):
        """Pad to the bucket size, record stats, stack the batches (the
        rows ``rows`` of the padded cohort, all by default) on the host and
        copy each leaf to the device once; padding rows repeat the last
        client (batches and, when given, client state, which is stacked on
        its device)."""
        k = len(batch_list)
        bucket = self._bucket(k)
        self.stats["cohort_calls"] += 1
        self.stats["clients"] += k
        self.stats["max_cohort"] = max(self.stats["max_cohort"], k)
        self.stats["padding_waste"] += bucket - k
        rows = rows or slice(0, bucket)
        padded = self._pad(batch_list, bucket)[rows]
        stacked = self._to_device(tree_map(lambda *xs: np.stack(xs),
                                           *padded))
        if cstate_list is None:
            return stacked, None
        return stacked, _stack(self._pad(cstate_list, bucket)[rows])

    def update_cohort(self, params, batch_list: List,
                      cstate_list: Optional[List] = None) -> DeltaBank:
        """Run the local update rule for every client in the cohort.

        ``batch_list``: one 3Q-leading-dim batch tree per client (the raw
        ``sample_batches`` output, numpy).  Returns a :class:`DeltaBank` over
        the per-client deltas in the same order.  All clients are computed
        against the same ``params`` (on the engine's device).

        Stateful strategies pass ``cstate_list``, one dispatch-ready
        client-state tree per client on the engine's device; the updated
        states come back on the bank (:meth:`DeltaBank.client_state`).
        """
        if self.stateful != (cstate_list is not None):
            raise ValueError("cstate_list must be given exactly when the "
                             "engine's strategy is stateful")
        k = len(batch_list)
        if k == 0:
            return self._emit(DeltaBank(rows=[], stats=self.stats))
        shared = self.strategy.shared_state() if self.stateful else None
        if self._mesh is not None:
            params = ctx.gather(params)   # model-replicated compute
        if not self.vectorized:
            self.stats["cohort_calls"] += 1
            self.stats["clients"] += k
            self.stats["max_cohort"] = max(self.stats["max_cohort"], k)
            if not self.stateful:
                return self._emit(DeltaBank(
                    rows=[self._one(params, self._to_device(b))
                          for b in batch_list], stats=self.stats))
            outs = [self._one_s(params, self._to_device(b), c, shared)
                    for b, c in zip(batch_list, cstate_list)]
            return self._emit(DeltaBank(
                rows=[d for d, _ in outs], stats=self.stats,
                cstate_rows=[c for _, c in outs]))
        outs = self._cohort(params, batch_list, cstate_list, shared)
        return self._emit(DeltaBank(
            stacked=outs[0], k=k, stats=self.stats,
            cstates=outs[1] if self.stateful else None))

    def _cohort(self, params, batch_list: List,
                cstate_list: Optional[List], shared) -> List:
        """The vectorized cohort call: ``[delta stack]``, or ``[delta
        stack, state stack]`` for a stateful strategy, each ``[bucket,
        ...]``."""
        if self._mesh is not None:
            return self._cohort_sharded(params, batch_list, cstate_list,
                                        shared)
        stacked, cstacked = self._pad_stack(batch_list, cstate_list)
        if self.cohort_impl == "map":
            return self._map_rows(params, stacked, cstacked, shared)
        # the mapped body returns a tuple of trees: (delta,) or (delta,
        # cstate); the shared state maps with an in-dim of None
        if self.stateful:
            one = lambda b, c, sh: self._one_s(params, b, c, sh)  # noqa
            in_dims, args = (0, 0, None), (stacked, cstacked, shared)
        else:
            one = lambda b: (self._one(params, b),)  # noqa: E731
            in_dims, args = (0,), (stacked,)
        return self._vmap(one, in_dims, *args)

    def _map_rows(self, params, stacked, cstacked, shared) -> List:
        """The rows of ``stacked`` one at a time: ``[delta stack]`` or
        ``[delta stack, state stack]``."""
        rows = []
        for r in range(tree_leaves(stacked)[0].shape[0]):
            b = tree_map(lambda x: x[r], stacked)
            if self.stateful:
                rows.append(self._one_s(params, b,
                                        tree_map(lambda x: x[r], cstacked),
                                        shared))
            else:
                rows.append((self._one(params, b),))
        return [_stack(list(col)) for col in zip(*rows)]

    def _cohort_sharded(self, params, batch_list: List,
                        cstate_list: Optional[List], shared) -> List:
        """The ``shard_map`` cohort call: this rank's slice of the bucket,
        stored as DTensor stacks split over "cohort" (the delta rows' model
        dims as their params', when the delta tree is params-shaped)."""
        bucket = self._bucket(len(batch_list))
        sl = ctx.cohort_slice(self._mesh, bucket)
        stacked, cstacked = self._pad_stack(batch_list, cstate_list,
                                            slice(sl.start, sl.stop))
        outs = self._map_rows(params, stacked, cstacked, shared)
        shardings = self._param_shardings
        delta = outs[0]
        if shardings is None \
                or len(tree_leaves(shardings)) != len(tree_leaves(delta)):
            # a personal-subset tree does not match the params' shardings:
            # it stays split over "cohort" only
            shardings = tree_map(lambda _: None, delta)
        placed = [tree_map(lambda x, sh: ctx.place_rows(
            x, self._mesh, bucket, None if sh is None else sh.placements),
            delta, shardings)]
        if self.stateful:
            placed.append(tree_map(lambda x: ctx.place_rows(
                x, self._mesh, bucket), outs[1]))
        return placed

    def update_cohort_mean(self, params, batch_list: List):
        """Cohort deltas reduced to their mean (sync FedAvg-family rounds),
        bucket padding left out of the reduction.  Split over a mesh, each
        rank sums its own rows under the mask and one ``all_reduce`` per
        leaf over the "cohort" group alone adds the slices: one crossing
        "model" would add every row once per model rank."""
        k = len(batch_list)
        if k == 0:
            raise ValueError("cohort mean over an empty batch_list")
        if self.stateful:
            raise ValueError("cstate_list must be given exactly when the "
                             "engine's strategy is stateful")
        if not self.vectorized:
            deltas = list(self.update_cohort(params, batch_list))
            return tree_map(lambda *xs: sum(xs) / k, *deltas)
        if self._mesh is not None:
            bucket = self._bucket(k)
            sl = ctx.cohort_slice(self._mesh, bucket)
            stacked, _ = self._pad_stack(batch_list, None,
                                         slice(sl.start, sl.stop))
            deltas = self._map_rows(ctx.gather(params), stacked, None,
                                    None)[0]
            mask = np.zeros(bucket, np.float32)
            mask[:k] = 1.0 / k
            m = torch.as_tensor(mask[sl.start:sl.stop]).to(self.device)
            return tree_map(lambda d: sl.all_reduce(torch.tensordot(
                m, d.float(), dims=([0], [0]))), deltas)
        deltas = self._cohort(params, batch_list, None, None)[0]
        return tree_map(lambda x: torch.mean(x[:k], dim=0), deltas)
