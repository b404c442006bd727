"""PersonalizationServer: submit/poll front-end over the cohort engine, as in
``src/repro/serving/server.py``.

Request lifecycle::

    t = server.submit(user, batch, mode="C")   # queued, stamped w/ window
    server.flush()                             # micro-batch -> cohort call
    head = server.poll(t)                      # head tree on the device
    ...
    server.advance_window()                    # fold deltas into global w

``flush`` turns the queue into pow2-bucketed cohort calls (one per (mode,
window-stamp) group), forms a stacked *head bank* ``heads = w_stamp −
delta_stack``, admits every real row into the
:class:`repro_torch.serving.bank.DeltaRing` and caches per-user head handles.
``advance_window`` closes the aggregation window: admitted rows (stragglers
included) are applied to the global params with one stacked apply per bank.

Steady state: submit → flush → poll/head → advance never copies a delta or a
head to the host.  Heads are gathers on the device, and
``stats["host_materializations"]`` stays 0; nothing here calls
``DeltaBank.row``, the one path that counts a materialization.

``personal_subset=`` banks only the personal leaves: delta rows, head rows,
ring snapshots and the head cache shrink to the subset, and served heads are
subset trees (merge them over the backbone with
:func:`repro_torch.core.merge_subset`).

``delta_dtype="int8"`` quantizes each flush's delta stack to int8 rows +
per-row-per-leaf f32 scales with **error feedback**: each user's
quantization error is banked as an int8 residual and added to the user's
next delta before it is quantized.  Heads are lazy
(:class:`repro_torch.core.quant.QuantizedHeads`, ``snapshot − scale·q`` per
gather), and the window apply sends the :class:`QuantStack` to the
``apply_rows_q`` kernel.

On a mesh (``cohort_impl="shard_map"``, ``mesh=``, ``param_shardings=``)
every rank of a ``torch.distributed`` ``DeviceMesh`` runs the same server
with the same submits (:mod:`repro_torch.sharding.ctx`): user cohorts split
over the "cohort" axis, the batcher keys users to cohort slices, and the
params, ring snapshots, delta banks and head banks are stored placed by
``param_shardings`` (model dims over "model").  Served heads and the params
after each window are the same bits on every mesh layout; polling a head is
a collective (the row comes from the rank that owns it, whole on every
rank).  Under int8 banking each rank quantizes its own rows at full
width (a row's scale is its own), so the codes are the same bits on every
layout; the codes are then placed as the fp32 rows were.  A demoted int8
snapshot is kept whole on every rank.

The socket front-end is :mod:`repro_torch.serving.transport`.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import load_meta, load_pytree, save_pytree
from repro_torch.convert import to_tensor
from repro_torch.core import init_server_state, staleness_stats
from repro_torch.core.quant import (QuantStack, QuantTree, QuantizedBank,
                                    QuantizedHeads, ef_quantize_stack)
from repro_torch.core.subset import SubsetSpec
from repro_torch.core.types import PersAFLConfig, ServerState
from repro_torch.device import resolve_device
from repro_torch.fl.engine import CohortEngine, DeltaBank
from repro_torch.serving.bank import DeltaRing
from repro_torch.serving.batcher import (MODES, MicroBatcher, Ticket,
                                         personalize_strategy)
from repro_torch.sharding import ctx
from repro_torch.tree import tree_leaves, tree_map


def _index(rows, device) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.long).to(device)


def _on(tree, device):
    """A loaded checkpoint tree (numpy arrays, bf16 CPU tensors) on
    ``device``."""
    return tree_map(lambda x: to_tensor(x, device), tree)


def _row_of(handle, row: int):
    """One head row from a ticket/cache handle, on the device either way:
    a view of an fp32 head bank, a dequantizing gather of a lazy
    :class:`QuantizedHeads`; a placed head bank's row comes whole from the
    rank that owns it."""
    if isinstance(handle, QuantizedHeads):
        return handle.row(row)
    return tree_map(lambda x: ctx.gather(ctx.take_row(x, row))
                    if ctx.is_sharded(x) else x[row], handle.stacked)


def _rows_of(handle, rows):
    if isinstance(handle, QuantizedHeads):
        return handle.rows(rows)
    leaf = tree_leaves(handle.stacked)[0]
    if ctx.is_sharded(leaf):
        return tree_map(lambda *xs: torch.stack(xs),
                        *[_row_of(handle, r) for r in rows])
    idx = _index(rows, leaf.device)
    return tree_map(lambda x: x.index_select(0, idx), handle.stacked)


def _heads_of(snap, stack):
    """The stacked head bank ``snap − stack`` in f32, stored in the params'
    dtypes; a placed delta stack gives a head bank placed as it is, each
    rank subtracting its own rows from its piece of the snapshot."""
    def one(p, d):
        head = (ctx.row_piece(p, d)[None].float() - ctx.local(d)).to(p.dtype)
        return ctx.like(head, d)
    return tree_map(one, snap, stack)


class PersonalizationServer:
    """Live-traffic serving of personalized heads (Options B and C).

    Parameters
    ----------
    init_params : global model w (copied onto ``device``; the server owns
                  its state)
    loss_fn     : (params, batch) -> scalar, the per-user objective f_i
    pcfg        : personalization hyper-params (α for mode B, λ/K/η_in for
                  mode C, β/damping for the window apply)
    cohort_impl : ``"auto"`` / ``"vmap"`` / ``"map"``, forwarded to each
                  mode's :class:`CohortEngine`
    windows     : ring depth W (banks + params snapshots retained)
    tau_max     : bounded-staleness admission (≤ W−1; default W−1)
    max_pending : auto-flush threshold for the request queue
    head_cache  : max cached per-user head handles (LRU)
    user_cap    : max delta rows one user may have admitted into one window
    personal_subset : the personal param subset (SubsetSpec spelling)
    delta_dtype : ``"fp32"`` or ``"int8"`` (quantized banking with per-user
                  error feedback)
    robust      : ``None``, ``"clip"`` or ``"trim"`` window apply, with
                  ``clip_norm`` / ``trim_frac``
    device      : the card unless ``"cpu"``; raises without a GPU (on a
                  mesh: this rank's device)
    mesh        : the ``DeviceMesh`` of the shard_map engines, 1-D
                  ``("cohort",)`` or 2-D ``("cohort", "model")``; defaults
                  to the :func:`use_mesh` context's, else the 1-D mesh
    param_shardings : a params-shaped tree of
                  :class:`repro_torch.sharding.rules.NamedSharding`: the
                  placement of the params, the snapshots and the model dims
                  of every bank and head row; forwarded to every engine
    """

    def __init__(self, init_params, loss_fn: Callable,
                 pcfg: PersAFLConfig, *, cohort_impl: str = "auto",
                 modes: Iterable[str] = MODES, windows: int = 4,
                 tau_max: Optional[int] = None, max_pending: int = 64,
                 head_cache: int = 4096, user_cap: Optional[int] = None,
                 personal_subset=None, delta_dtype: str = "fp32",
                 robust: Optional[str] = None,
                 clip_norm: Optional[float] = None,
                 trim_frac: float = 0.1,
                 mesh=None, param_shardings=None, device="cuda"):
        self.device = resolve_device(device)
        self.pcfg = pcfg
        self.loss_fn = loss_fn
        self.state = init_server_state(init_params, self.device)
        self.max_pending = max_pending
        self.head_cache = head_cache
        self.delta_dtype = delta_dtype
        self.personal_subset = SubsetSpec.resolve(personal_subset,
                                                 self.state.params)

        engines: Dict[str, CohortEngine] = {}
        shared_stats = None
        for mode in modes:
            eng = CohortEngine(
                pcfg, loss_fn, cohort_impl=cohort_impl, device=self.device,
                mesh=mesh, param_shardings=param_shardings,
                strategy=personalize_strategy(
                    pcfg, loss_fn, mode,
                    personal_subset=self.personal_subset))
            if shared_stats is None:
                shared_stats = eng.stats
            else:
                eng.stats = shared_stats  # one counter set across modes
            engines[mode] = eng
        if not engines:
            raise ValueError("need at least one personalization mode")
        self.engines = engines
        self._engine_stats = shared_stats
        # placed up front: snapshots, delta banks and head rows follow the
        # params they were computed against
        self.state.params = next(iter(engines.values())).place_params(
            self.state.params)

        self.ring = DeltaRing(self.state.params, windows=windows,
                              tau_max=tau_max, user_cap=user_cap,
                              subset=self.personal_subset,
                              delta_dtype=delta_dtype, robust=robust,
                              clip_norm=clip_norm, trim_frac=trim_frac)
        if delta_dtype == "fp32":
            for eng in engines.values():
                eng.add_bank_hook(self.ring.retain)   # bank handoff
        # under int8 the fp32 cohort bank is transient: the flush quantizes
        # it and retains only the QuantizedBank
        n_shards = max(eng._ndev for eng in engines.values())
        self.batcher = MicroBatcher(engines, n_shards=n_shards,
                                    user_cap=user_cap)
        # user -> (heads handle, row): on the device, LRU-evicted
        self._heads: "collections.OrderedDict" = collections.OrderedDict()
        # user -> (residual QuantizedBank, row): the quantization error of
        # the user's last banked delta (error feedback), LRU-evicted
        self._residuals: "collections.OrderedDict" = \
            collections.OrderedDict()

    # -- request path ------------------------------------------------------

    @property
    def params(self):
        """The current global model w (post last window apply)."""
        return self.state.params

    @property
    def window(self) -> int:
        return self.ring.current

    def submit(self, user, batch, mode: str = "C") -> Ticket:
        """Queue one personalization request; stamps the current window."""
        ticket = self.batcher.submit(
            Ticket(user=user, mode=mode, stamp=self.ring.current), batch)
        if len(self.batcher) >= self.max_pending:
            self.flush()
        return ticket

    def flush(self) -> int:
        """Drain the queue into cohort calls; returns #requests served.

        Per (mode, stamp) group: one cohort call against the stamped
        snapshot, one stacked head computation (or, under int8, a lazy head
        view over the quantized bank), then per-row ring admission and
        head-cache insertion.
        """
        served = 0
        for mode, stamp, bank, placed in self.batcher.drain(
                self.ring.current, self.ring.snapshot,
                tau_max=self.ring.tau_max):
            resbank = None
            if self.delta_dtype == "int8":
                bank, resbank = self._quantize_bank(bank, placed)
                self.ring.retain(bank)
                heads = QuantizedHeads(self.ring.subset_snapshot(stamp),
                                       bank)
            else:
                heads = DeltaBank(
                    stacked=_heads_of(self.ring.subset_snapshot(stamp),
                                      bank.stacked),
                    k=bank.k, stats=self._engine_stats)
                self.ring.retain(heads)  # head rows live with the bank
            for ticket, row in placed:
                # the ring is the admission authority; a refusal keeps its
                # cause ("capped" or "dropped") for poll
                verdict = self.ring.admit_row(ticket.user, bank, row,
                                              ticket.tau)
                if verdict != "admitted":
                    ticket.status = verdict
                    continue
                self._cache_head(ticket.user, heads, row)
                if resbank is not None:
                    # the row's new quantization error replaces the user's
                    # banked one (the EF recurrence); refused rows never
                    # apply, so their user keeps the old residual
                    self._cache_residual(ticket.user, resbank, row)
                ticket.head = (heads, row)
                ticket.window = self.ring.current
                ticket.status = "done"
                served += 1
        return served

    # -- quantized banking (error feedback) --------------------------------

    def _quantize_bank(self, bank: DeltaBank, placed):
        """int8-quantize a cohort's delta stack with error feedback; returns
        ``(delta QuantizedBank, residual QuantizedBank)``.  A placed stack
        is quantized one rank's rows at a time, at full row width, and the
        codes placed back as its rows were."""
        raw = bank.stacked
        start, _ = ctx.row_block(tree_leaves(raw)[0])
        mine = tree_map(ctx.cohort_rows, raw)
        residual = self._residual_stack(mine, placed, start)
        qstack, resstack = ef_quantize_stack(mine, residual)

        def place(qs):
            return QuantStack(
                q=tree_map(ctx.place_like_rows, qs.q, raw),
                scales=tree_map(ctx.place_like_rows, qs.scales, raw))
        return (QuantizedBank(place(qstack), k=bank.k),
                QuantizedBank(place(resstack), k=bank.k))

    def _residual_stack(self, raw, placed, start: int = 0):
        """f32 residual stack row-aligned with ``raw`` (the rows from
        ``start`` on of the cohort; None if no placed user has a banked
        residual); one dequantizing gather per source bank.  A user twice
        in one cohort is credited once (first row)."""
        seen = set()
        groups: Dict[int, list] = {}
        for ticket, row in placed:
            user = ticket.user
            if user in seen or user not in self._residuals:
                continue
            seen.add(user)
            src_bank, src_row = self._residuals[user]
            groups.setdefault(id(src_bank), [src_bank, [], []])
            groups[id(src_bank)][1].append(src_row)
            groups[id(src_bank)][2].append(row)
        if not groups:
            return None
        out = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=x.device), raw)
        n = tree_leaves(raw)[0].shape[0]
        for src_bank, src_rows, dst_rows in groups.values():
            # every rank gathers every source row (a collective on a mesh)
            # and keeps those of its own block
            vals = src_bank.rows(src_rows)
            keep = [j for j, r in enumerate(dst_rows)
                    if start <= r < start + n]
            if not keep:
                continue
            dst = _index([dst_rows[j] - start for j in keep], self.device)
            sel = _index(keep, self.device)
            tree_map(lambda o, v: o.index_copy_(
                0, dst, v.index_select(0, sel).float()), out, vals)
        return out

    def _cache_residual(self, user, resbank: QuantizedBank,
                        row: int) -> None:
        self._residuals[user] = (resbank, row)
        self._residuals.move_to_end(user)
        while len(self._residuals) > self.head_cache:
            self._residuals.popitem(last=False)

    def poll(self, ticket: Ticket):
        """None while queued; THIS ticket's head tree once served.  Raises
        on dropped (staleness bound), capped (fairness) and
        superseded-and-retired tickets (the ticket's window rotated out of
        the ring)."""
        if ticket.status == "queued":
            return None
        if ticket.status == "dropped":
            raise RuntimeError(
                f"request for {ticket.user!r} exceeded tau_max="
                f"{self.ring.tau_max} (tau={ticket.tau}); re-submit")
        if ticket.status == "capped":
            raise RuntimeError(
                f"request for {ticket.user!r} exceeded the per-window "
                f"fairness cap (user_cap={self.batcher.user_cap}); "
                f"re-submit next window")
        if ticket.head is None:
            # a done ticket without a handle (built by hand, or from before
            # a restart): the cache is the only resolver left
            if ticket.user not in self._heads:
                raise RuntimeError(
                    f"head for {ticket.user!r} was evicted from the cache "
                    f"(head_cache={self.head_cache}); re-submit")
            return self.head(ticket.user)
        horizon = self.ring.current - self.ring.windows + 1
        if ticket.window < horizon:
            ticket.head = None   # the bank is gone; drop our pin on it
            raise RuntimeError(
                f"ticket for {ticket.user!r} was superseded and retired: "
                f"served in window {ticket.window}, ring horizon is "
                f"{horizon} (windows={self.ring.windows}); re-submit")
        heads, row = ticket.head
        return _row_of(heads, row)

    def _cache_head(self, user, heads, row: int) -> None:
        self._heads[user] = (heads, row)
        self._heads.move_to_end(user)
        while len(self._heads) > self.head_cache:
            self._heads.popitem(last=False)

    def head(self, user):
        """The user's personalized head: a row of the stacked head bank on
        the device (never a host copy)."""
        heads, row = self._heads[user]
        self._heads.move_to_end(user)
        return _row_of(heads, row)

    def stacked_heads(self, users: List):
        """``[len(users), ...]`` stacked heads: one gather when every user
        sits in the same head bank, a stack of rows otherwise."""
        handles = [self._heads[u] for u in users]
        first = handles[0][0]
        if all(h is first for h, _ in handles):
            return _rows_of(first, [r for _, r in handles])
        return tree_map(lambda *xs: torch.stack(xs),
                        *[self.head(u) for u in users])

    # -- window boundary ---------------------------------------------------

    def advance_window(self, *, flush: bool = True) -> None:
        """Close the aggregation window: fold every admitted delta row
        (stragglers re-weighted) into the global params and rotate the
        ring.  ``flush=False`` leaves queued requests queued; the next
        flush computes them against their stamped snapshot as stragglers.
        """
        if flush:
            self.flush()
        self.state = self.ring.advance(self.state, beta=self.pcfg.beta,
                                       damping=self.pcfg.staleness_damping)

    # -- restart warm-start ------------------------------------------------

    @staticmethod
    def _ckpt_snap(snap):
        """A demoted snapshot is stored as ``{"__q8__": q, "__q8s__":
        scales}`` (the reference's marker dict), codes and scales
        bit-exact."""
        if isinstance(snap, QuantTree):
            return {"__q8__": snap.q, "__q8s__": snap.scales}
        return snap

    def _unckpt_snap(self, snap):
        if isinstance(snap, dict) and set(snap) == {"__q8__", "__q8s__"}:
            return QuantTree(q=_on(snap["__q8__"], self.device),
                             scales=_on(snap["__q8s__"], self.device))
        return _on(snap, self.device)

    def _gathered_residuals(self):
        """(stacked residual QuantStack, users): one row per cached user,
        gathered without dequantizing, so save→restore is bit-exact."""
        users = list(self._residuals)
        if not users:
            return None, []
        groups: Dict[int, list] = {}
        for i, user in enumerate(users):
            src_bank, src_row = self._residuals[user]
            groups.setdefault(id(src_bank), [src_bank, [], []])
            groups[id(src_bank)][1].append(src_row)
            groups[id(src_bank)][2].append(i)
        template = ctx.gather(next(iter(groups.values()))[0].stacked)
        n = len(users)
        q = tree_map(lambda x: torch.zeros((n,) + tuple(x.shape[1:]),
                                           dtype=x.dtype, device=x.device),
                     template.q)
        s = tree_map(lambda x: torch.zeros((n,), dtype=x.dtype,
                                           device=x.device), template.scales)
        for src_bank, src_rows, dst_rows in groups.values():
            src = _index(src_rows, self.device)
            dst = _index(dst_rows, self.device)
            stack = ctx.gather(src_bank.stacked)   # a placed bank, whole
            tree_map(lambda o, x: o.index_copy_(0, dst,
                                                x.index_select(0, src)),
                     q, stack.q)
            tree_map(lambda o, x: o.index_copy_(0, dst,
                                                x.index_select(0, src)),
                     s, stack.scales)
        return QuantStack(q=q, scales=s), users

    def save(self, path: str) -> None:
        """Checkpoint the serving state through
        :mod:`repro_torch.checkpoint.store`, in the reference's layout: the
        ServerState, the ring's snapshots + window counter + cumulative
        stats, the head cache as one stacked head bank and, under int8, the
        per-user EF residuals as codes + scales.  Unapplied admissions are
        not saved."""
        users = list(self._heads)
        res_stack, res_users = self._gathered_residuals()
        tree = {
            # placed params and snapshots are saved whole
            "server_state": ctx.gather(self.state.as_dict()),
            "ring_snapshots": {f"w{w}": self._ckpt_snap(ctx.gather(snap))
                               for w, snap in self.ring._snapshots.items()},
            "head_stack": self.stacked_heads(users) if users else None,
            "residuals": ({"q": res_stack.q, "scales": res_stack.scales}
                          if res_stack is not None else None),
        }
        meta = {"users": users, "ring_current": self.ring.current,
                "windows": self.ring.windows,
                "tau_max": self.ring.tau_max_requested,
                "user_cap": self.ring.user_cap,
                "delta_dtype": self.delta_dtype,
                "residual_users": res_users,
                "personal_subset":
                    self.personal_subset.descriptor(self.state.params)
                    if self.personal_subset is not None else None,
                "ring_stats": {k: int(v)
                               for k, v in self.ring.stats.items()}}
        save_pytree(path, tree, meta=meta)

    @classmethod
    def restore(cls, path: str, loss_fn: Callable, pcfg: PersAFLConfig,
                **kw) -> "PersonalizationServer":
        """Rebuild a server from :meth:`save`'s checkpoint (either
        package's).  Ring depth, staleness bound, fairness cap, subset and
        codec come from the checkpoint unless ``**kw`` overrides them;
        ``**kw`` otherwise forwards the process-local knobs (``device``,
        ``cohort_impl``, ``modes``, ``max_pending``, ``head_cache``)."""
        tree = load_pytree(path)
        meta = load_meta(path)
        ss = tree["server_state"]
        windows = kw.pop("windows", meta["windows"])
        tau_max = kw.pop("tau_max", meta.get("tau_max"))
        user_cap = kw.pop("user_cap", meta.get("user_cap"))
        subset = kw.pop("personal_subset", meta.get("personal_subset"))
        delta_dtype = kw.pop("delta_dtype",
                             meta.get("delta_dtype", "fp32"))
        srv = cls(ss["params"], loss_fn, pcfg, windows=windows,
                  tau_max=tau_max, user_cap=user_cap,
                  personal_subset=subset, delta_dtype=delta_dtype, **kw)
        srv.state = ServerState(
            params=srv.state.params, t=np.int32(ss["t"]),
            staleness_sum=np.float32(ss["staleness_sum"]),
            staleness_max=np.int32(ss["staleness_max"]))
        snapshots = {int(k[1:]): srv._unckpt_snap(snap)
                     for k, snap in tree["ring_snapshots"].items()}
        srv.ring.load(snapshots, meta["ring_current"],
                      stats=meta.get("ring_stats"))
        users = meta["users"]
        if users:
            heads = DeltaBank(stacked=_on(tree["head_stack"], srv.device),
                              k=len(users), stats=srv._engine_stats)
            if delta_dtype == "fp32":
                # under int8 this is a materialized fp32 head stack:
                # retaining it would skew the ring's quantized row bytes
                srv.ring.retain(heads)
            for row, user in enumerate(users):
                srv._cache_head(user, heads, row)
        res_users = meta.get("residual_users") or []
        if res_users and tree.get("residuals") is not None:
            stack = QuantStack(q=_on(tree["residuals"]["q"], srv.device),
                               scales=_on(tree["residuals"]["scales"],
                                          srv.device))
            resbank = QuantizedBank(stack, k=len(res_users))
            for row, user in enumerate(res_users):
                srv._cache_residual(user, resbank, row)
        return srv

    # -- observability -----------------------------------------------------

    @property
    def stats(self) -> Dict:
        s = dict(self._engine_stats)
        s.update({f"ring_{k}": v for k, v in self.ring.stats.items()})
        s.update({f"batcher_{k}": v for k, v in self.batcher.stats.items()})
        s["live_banks"] = self.ring.live_banks
        s["cached_heads"] = len(self._heads)
        # per-user steady-state ring residency, 2 rows per served user:
        # fp32 banking keeps a delta row + a head row, int8 banking a delta
        # row + an EF residual row (its heads are lazy views)
        row = self.ring.row_nbytes or 0
        row_fp32 = self.ring.row_nbytes_fp32 or row
        s["ring_row_bytes"] = row
        s["ring_bytes_per_user"] = 2 * row
        s["ring_bytes_per_user_fp32"] = 2 * row_fp32
        s["ring_bytes_saved_per_user"] = 2 * (row_fp32 - row)
        s["delta_codec"] = self.delta_dtype
        return s

    def staleness(self) -> Dict:
        return staleness_stats(self.state)
