"""Strategy/Scheduler API: one run surface, as in ``src/repro/fl/api.py``.

  * :class:`Strategy` — the local update rule.  ``local_update(params,
    batches, cstate) -> (delta, cstate, metrics)``; instances come from the
    registry (``strategy("persafl", option="B")``, ``strategy("fedprox",
    mu=0.1)``, ``strategy("scaffold")``).  Client state is a stacked tree
    carried through the cohort's ``vmap``, so the stateful SCAFFOLD runs
    the same cohort engine and DeltaBank path as every other rule.
  * :class:`ApplyPolicy` — the server apply schedule: ``immediate()`` is
    Algorithm 1's per-arrival apply, ``buffered(M)`` the FedBuff-style
    M-deltas-per-round flush consumed straight from the bank through the
    ``apply_rows`` weight vector, ``sync_barrier(m)`` FedAvg-family rounds
    that wait for the slowest of m sampled clients.
  * :class:`FLRun` — the event-loop core composing the two over a
    :class:`DelayModel` timeline.

The event timeline is numpy and Python (the heap of ``(t, client, kind)``
events or the vectorized :class:`repro_torch.fl.scenario.EventStream`,
``FLRun.rng`` batch draws), so it is the reference's to the bit.  A
:class:`repro_torch.fl.scenario.ChurnModel` with adversaries corrupts the
cohort's bank rows on the device right after the cohort call.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad

from repro_torch.core import (PersAFLConfig, admission_weights,
                              apply_buffered_rows, apply_update,
                              client_update, init_server_state, mask_rows,
                              robust_flush_weights, scale_rows, solve_prox,
                              split_batches_for_option)
from repro_torch.core.server import staleness_stats
from repro_torch.core.subset import SubsetSpec, merge_subset
from repro_torch.data.federated import sample_batches
from repro_torch.device import resolve_device
from repro_torch.fl.algorithms import fedprox_update, scaffold_update
from repro_torch.fl.engine import CohortEngine, DeltaBank
from repro_torch.fl.scenario.sched import EventStream, heap_events
from repro_torch.sharding import ctx
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class History:
    """Run trace shared by every schedule: accuracy-vs-simulated-time,
    active-client ratio on a time grid (paper Figure 2a), and per-applied-
    update staleness (empty for sync rounds).  ``loss`` is recorded beside
    ``acc`` when the run's ``eval_fn`` reports one."""
    times: List[float] = dataclasses.field(default_factory=list)
    rounds: List[int] = dataclasses.field(default_factory=list)
    acc: List[float] = dataclasses.field(default_factory=list)
    loss: List[float] = dataclasses.field(default_factory=list)
    active_times: List[float] = dataclasses.field(default_factory=list)
    active_ratio: List[float] = dataclasses.field(default_factory=list)
    staleness: List[int] = dataclasses.field(default_factory=list)
    # simulated time at which the run stopped (clamped to max_time when
    # that budget binds)
    end_time: float = 0.0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _normalize_eval(result) -> Tuple[float, Optional[float]]:
    """An ``eval_fn`` return as ``(acc, loss-or-None)``: a bare scalar, an
    ``(acc, loss)`` pair, or a dict with ``"acc"`` and optional ``"loss"``."""
    if isinstance(result, dict):
        loss = result.get("loss")
        return float(result["acc"]), None if loss is None else float(loss)
    if isinstance(result, (tuple, list)):
        if len(result) != 2:
            raise ValueError(f"eval_fn returned a {len(result)}-sequence; "
                             f"expected (acc, loss)")
        return float(result[0]), float(result[1])
    return float(result), None


# ---------------------------------------------------------------------------
# Strategy protocol + registry
# ---------------------------------------------------------------------------

class Strategy:
    """A local update rule with a client-state lifecycle.

      * ``init_client_state(params)`` — the per-client state carried across
        rounds (None for stateless rules; SCAFFOLD returns its control
        variate c_i).
      * ``local_update(params, batches, cstate) -> (delta, cstate, metrics)``
        — one client's contribution against a frozen params snapshot; the
        delta is params-shaped f32 (bank-row compatible).
      * ``dispatch_state(cstate)`` — host-side hook run right before a
        cohort dispatch (identity by default).
      * ``shared_state()`` / ``assemble_state(cstate, shared)`` — the
        strategy-shared input, read once per cohort call and passed to the
        cohort's ``vmap`` unbatched (in-dim None), recombined with each
        client's row inside the mapped body: SCAFFOLD ships one c_global per
        call, not one copy per cohort row.
      * ``post_round(updates, n_clients)`` — host-side hook run after the
        cohort's states are written back; ``updates`` is ``[(client_index,
        old_cstate, new_cstate), ...]`` in dispatch order.

    :meth:`bind` attaches the run's (pcfg, loss_fn) and resets any
    strategy-shared state.
    """

    name = "strategy"
    option = "A"        # batch-split layout, for introspection
    stateful = False

    def bind(self, pcfg: PersAFLConfig, loss_fn: Callable) -> "Strategy":
        self.pcfg = pcfg
        self.loss_fn = loss_fn
        return self

    def init_client_state(self, params):
        return None

    def dispatch_state(self, cstate):
        return cstate

    def shared_state(self):
        """Strategy-shared cohort input, passed unbatched; None for
        strategies without one."""
        return None

    def assemble_state(self, cstate, shared):
        """One client's state row recombined with the shared input inside
        the mapped cohort body (identity for shared-less strategies)."""
        return cstate

    def local_update(self, params, batches, cstate):
        raise NotImplementedError

    def post_round(self, updates: List[Tuple[int, object, object]],
                   n_clients: int) -> None:
        pass


_REGISTRY: Dict[str, Callable[..., Strategy]] = {}


def register_strategy(*names):
    """Class decorator: ``@register_strategy("name")`` makes the rule
    constructible as ``strategy("name", **kw)``."""
    def deco(factory):
        for nm in names:
            _REGISTRY[nm] = factory
        return factory
    return deco


def strategy(name: str, **kw) -> Strategy:
    """Construct a registered strategy: ``strategy("persafl", option="B")``,
    ``strategy("fedprox", mu=0.1)``, ``strategy("scaffold")``, …"""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"have {sorted(_REGISTRY)}") from None
    return factory(**kw)


def strategy_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_strategy(s) -> Strategy:
    if isinstance(s, str):
        return strategy(s)
    if isinstance(s, Strategy):
        return s
    raise TypeError(f"strategy must be a name or a Strategy, got {type(s)}")


@register_strategy("persafl")
class PersAFLStrategy(Strategy):
    """Algorithm 2, Options A/B/C: Q local steps of plain SGD (A), MAML (B)
    or Moreau-envelope prox grads (C).  ``option=None`` takes the bound
    pcfg's option."""

    name = "persafl"

    def __init__(self, option: Optional[str] = None):
        self._option = option

    def bind(self, pcfg, loss_fn):
        self.option = self._option or pcfg.option
        return super().bind(dataclasses.replace(pcfg, option=self.option),
                            loss_fn)

    def local_update(self, params, batches_3q, cstate):
        delta, metrics = client_update(
            self.pcfg, self.loss_fn, params,
            split_batches_for_option(self.option, batches_3q))
        return delta, None, metrics


# the §5 baseline names are option presets of the same rule
for _nm, _opt in (("fedavg", "A"), ("fedasync", "A"),
                  ("perfedavg", "B"), ("pfedme", "C")):
    _REGISTRY[_nm] = functools.partial(PersAFLStrategy, option=_opt)


@register_strategy("fedprox")
class FedProxStrategy(Strategy):
    """FedProx [42]: local SGD on f_i(w) + μ/2 ‖w − w^t‖² over the first Q
    of the 3Q batches (Option A's layout).  Stateless."""

    name = "fedprox"

    def __init__(self, mu: float = 0.1):
        self.mu = mu

    def bind(self, pcfg, loss_fn):
        return super().bind(dataclasses.replace(pcfg, option="A"), loss_fn)

    def local_update(self, params, batches_3q, cstate):
        q = self.pcfg.q_local
        delta, metrics = fedprox_update(
            self.pcfg, self.loss_fn, params,
            tree_map(lambda x: x[:q], batches_3q), mu=self.mu)
        return delta, None, metrics


@register_strategy("scaffold")
class ScaffoldStrategy(Strategy):
    """SCAFFOLD [34] (Option I), the stateful registry strategy.

    Per-client state is the control variate c_i (params-shaped f32, stacked
    over the cohort axis); the shared c_global enters every cohort call
    through :meth:`shared_state` and is updated on the host in
    :meth:`post_round`: c_global += (c_i⁺ − c_i)/n per participating
    client, leaf by leaf, in dispatch order.
    """

    name = "scaffold"
    stateful = True

    def bind(self, pcfg, loss_fn):
        self.c_global = None
        return super().bind(dataclasses.replace(pcfg, option="A"), loss_fn)

    def init_client_state(self, params):
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        if self.c_global is None:
            self.c_global = zeros
        return zeros

    def shared_state(self):
        return self.c_global

    def assemble_state(self, cstate, shared):
        return {"c": shared, "c_i": cstate}

    def local_update(self, params, batches_3q, dstate):
        q = self.pcfg.q_local
        return scaffold_update(
            self.pcfg, self.loss_fn, params,
            tree_map(lambda x: x[:q], batches_3q), dstate["c"],
            dstate["c_i"])

    def post_round(self, updates, n_clients):
        for _, c_old, c_new in updates:
            self.c_global = tree_map(
                lambda cg, cn, co: cg + (cn - co) / n_clients,
                self.c_global, c_new, c_old)


@register_strategy("personalize")
class PersonalizeStrategy(Strategy):
    """Serving-side personalization delta (head = w − delta).

    mode "B": delta = α ∇f(w; D)   (head = the one-step MAML fine-tune)
    mode "C": delta = w − θ̃(w)     (head = the Moreau prox solution θ̃)

    ``batches`` is the user's raw request batch (no leading-Q axis).  The
    delta is f32, so bank rows go straight to the stacked server apply;
    this is the rule behind
    :class:`repro_torch.serving.PersonalizationServer`.  With
    ``personal_subset`` set, the gradient or prox solve runs over the
    subset leaves against a frozen backbone and the delta comes back in the
    pruned subset structure.
    """

    name = "personalize"

    def __init__(self, mode: str = "C", personal_subset=None):
        if mode not in ("B", "C"):
            raise ValueError(f"unknown personalization mode {mode!r}; "
                             f"have ('B', 'C')")
        self.mode = mode
        self.option = mode
        self.personal_subset = SubsetSpec.resolve(personal_subset)

    def local_update(self, params, batch, cstate):
        spec = self.personal_subset
        if spec is None:
            sub0, loss_fn = params, self.loss_fn
        else:
            # torch.func differentiates lists of tensors, not the pruned
            # tree's None slots: the subset travels as its list of leaves
            # and the closure rebuilds it and merges it over the backbone
            template = spec.extract(params)
            sub0 = tree_leaves(template)

            def loss_fn(leaves, b):
                return self.loss_fn(
                    merge_subset(params, tree_unflatten(template, leaves)),
                    b)
        if self.mode == "B":
            g = grad(loss_fn)(sub0, batch)
            delta = tree_map(lambda gg: self.pcfg.alpha * gg.float(), g)
        else:
            theta, _ = solve_prox(loss_fn, sub0, batch, self.pcfg.lam,
                                  self.pcfg.inner_eta, self.pcfg.inner_steps)
            delta = tree_map(lambda w, t: w.float() - t.float(), sub0,
                             theta)
        if spec is not None:
            delta = tree_unflatten(template, delta)
        return delta, None, {}


# ---------------------------------------------------------------------------
# Apply policies (server schedules)
# ---------------------------------------------------------------------------

class ApplyPolicy:
    """Server apply schedule.  ``kind="event"`` policies plug into the
    async discrete-event loop via :meth:`on_upload`; ``kind="round"``
    policies drive barrier rounds.  One instance per FLRun."""

    kind = "event"
    default_eval_every = 50

    def start(self, run: "FLRun") -> None:
        """Reset per-run policy state (called at the top of ``run()``)."""

    def on_upload(self, run: "FLRun", now: float, rid: int, version: int,
                  hist: History, eval_fn, eval_every: int) -> None:
        raise NotImplementedError


class Immediate(ApplyPolicy):
    """Paper-faithful Algorithm 1: apply each delta the moment it lands
    (staleness τ measured per update)."""

    def on_upload(self, run, now, rid, version, hist, eval_fn, eval_every):
        run._flush()
        bank, idx = run._computed.pop(rid)
        # per-row host materialization keeps the reference's single-delta
        # semantics: one copy of the whole bank to the host, host views per
        # row after that, and one copy of the row back per apply
        delta = bank.row(idx)
        # _t mirrors state.t on the host
        staleness = run._t - version
        hist.staleness.append(staleness)
        run.state = apply_update(run.state, delta, run.pcfg.beta, staleness,
                                 damping=run.pcfg.staleness_damping)
        run._record_window(now, 1, [staleness])
        run._t += 1
        if eval_fn is not None and run._t % eval_every == 0:
            run._record_eval(hist, now, eval_fn, run._t)


class Buffered(ApplyPolicy):
    """FedBuff-style buffered apply: arrivals accumulate in a size-M
    buffer; a full buffer flushes as ONE w ← w − β/M ΣΔ server round
    consumed straight from the on-device DeltaBank through the ``apply_rows``
    weight vector (β/M, per-delta damping ``(1+τ)^{-a}`` and padding masks
    are rows of one ``[bucket]`` array).  t advances in M-sized jumps;
    staleness Σ/max are accounted per contributing delta.

    ``robust="clip"`` / ``"trim"`` routes the flush through
    :func:`repro_torch.core.robust_flush_weights`: per-row norm clipping
    or a norm-based trimmed mean calibrated over the whole buffer, across
    the banks its rows live in (row norms reduced on the device,
    non-finite rows zeroed through :func:`repro_torch.core.mask_rows`).
    Under trim, t still advances by the full buffer size."""

    def __init__(self, m: Optional[int] = None, *,
                 robust: Optional[str] = None,
                 clip_norm: Optional[float] = None,
                 trim_frac: float = 0.1):
        if robust not in (None, "clip", "trim"):
            raise ValueError(f"robust must be None, 'clip' or 'trim', "
                             f"got {robust!r}")
        self.robust = robust
        self.clip_norm = clip_norm
        self.trim_frac = trim_frac
        self.m = m                # configured; None = the run's pcfg M

    def start(self, run):
        # resolved per run — m=None must re-read each run's buffer_size
        self.m_effective = self.m if self.m is not None \
            else max(int(run.pcfg.buffer_size), 1)
        self._buffer: List[Tuple[int, int]] = []  # (rid, staleness)

    def on_upload(self, run, now, rid, version, hist, eval_fn, eval_every):
        staleness = run._t - version
        hist.staleness.append(staleness)
        self._buffer.append((rid, staleness))
        if len(self._buffer) < self.m_effective:
            return
        run._flush()  # compute buffered AND in-flight pending deltas
        m = len(self._buffer)
        damping = run.pcfg.staleness_damping
        # group the buffer's rows by owning DeltaBank (in-flight clients
        # were computed in an earlier window's bank) and consume each bank
        # on the device with one weight vector
        groups: Dict[int, Tuple[DeltaBank, List[Tuple[int, int]]]] = {}
        for r, s in self._buffer:
            bank, idx = run._computed.pop(r)
            groups.setdefault(id(bank), (bank, []))[1].append((idx, s))
        t_old = run._t
        robust_info = {"clipped": 0, "trimmed": 0, "nonfinite": 0}
        if self.robust is not None:
            # one call for the whole flush: the defense calibrates over
            # all m admissions, not per owning bank
            per_bank, robust_info = robust_flush_weights(
                groups, beta=run.pcfg.beta, count=m, damping=damping,
                method=self.robust, clip_norm=self.clip_norm,
                trim_frac=self.trim_frac)
        for key, (bank, rows) in groups.items():
            if self.robust is not None:
                weights, keep = per_bank[key]
                # non-finite rows are masked out of the stack, not just
                # zero-weighted: 0 × NaN = NaN
                stack = bank.stacked if bool(keep.all()) \
                    else mask_rows(bank.stacked, keep)
            else:
                weights = admission_weights(bank.capacity, rows,
                                            beta=run.pcfg.beta, count=m,
                                            damping=damping)
                stack = bank.stacked
            run.state = apply_buffered_rows(
                run.state, stack, weights, len(rows),
                staleness_max=max(s for _, s in rows),
                staleness_sum=float(sum(s for _, s in rows)))
        run._record_window(now, m, [s for _, s in self._buffer],
                           robust_clipped=robust_info["clipped"],
                           robust_trimmed=robust_info["trimmed"],
                           robust_nonfinite=robust_info["nonfinite"])
        self._buffer = []
        run._t = t_old + m
        # t jumps by M per flush: eval whenever a multiple of eval_every
        # is crossed
        if eval_fn is not None \
                and run._t // eval_every > t_old // eval_every:
            run._record_eval(hist, now, eval_fn, run._t)


class SyncBarrier(ApplyPolicy):
    """FedAvg-family synchronous rounds: sample m clients, wait for the
    slowest, fold the cohort's bank into the params with one ``apply_rows``
    pass (weights = β/m on real rows, 0 on padding)."""

    kind = "round"
    default_eval_every = 5

    def __init__(self, m: int = 10):
        self.m = m


def immediate() -> Immediate:
    return Immediate()


def buffered(m: Optional[int] = None, *, robust: Optional[str] = None,
             clip_norm: Optional[float] = None,
             trim_frac: float = 0.1) -> Buffered:
    """``m=None`` takes ``pcfg.buffer_size`` at run time.  ``robust=``
    selects the Byzantine-robust flush ("clip" / "trim"; see
    :class:`Buffered`)."""
    return Buffered(m, robust=robust, clip_norm=clip_norm,
                    trim_frac=trim_frac)


def sync_barrier(m: int = 10) -> SyncBarrier:
    return SyncBarrier(m)


_SCHEDULES: Dict[str, Callable[[], ApplyPolicy]] = {
    "immediate": immediate, "buffered": buffered,
    "sync": sync_barrier, "sync_barrier": sync_barrier,
}


def resolve_schedule(s) -> ApplyPolicy:
    if isinstance(s, str):
        try:
            return _SCHEDULES[s]()
        except KeyError:
            raise ValueError(f"unknown schedule {s!r}; "
                             f"have {sorted(_SCHEDULES)}") from None
    if isinstance(s, ApplyPolicy):
        return s
    raise TypeError(f"schedule must be a name or an ApplyPolicy, "
                    f"got {type(s)}")


# ---------------------------------------------------------------------------
# FLRun — the one event-loop core
# ---------------------------------------------------------------------------

class FLRun:
    """One federated run = a Strategy × an ApplyPolicy × a DelayModel, on
    ``device`` (the card unless ``device="cpu"``).

    Per-client compute is deferred: batches are recorded when a download
    completes and materialized lazily in one :class:`CohortEngine` cohort
    call right before the next server apply, so every delta is computed on
    the snapshot the per-event path would have used.  ``vectorized=False``
    keeps the per-event sequential dispatch.

    ``scheduler`` picks the event source of the immediate and buffered
    schedules: ``"heap"`` (per-event heap), ``"device"`` (the vectorized
    :class:`repro_torch.fl.scenario.EventStream`, bit-equal to the heap) or
    ``"auto"`` (the stream from 4096 clients up); ``sync_barrier`` ignores
    it.

    ``mesh`` and ``param_shardings`` go through to the engine (see
    :class:`CohortEngine`): with ``cohort_impl="shard_map"`` every rank of
    the mesh runs this same program and computes its own cohort slice.
    Given ``param_shardings``, the params are stored placed by it from the
    start and stay so after every server apply; the evaluation and the
    client-state init see them whole.
    """

    def __init__(self, *, clients: List, loss_fn: Callable, init_params,
                 pcfg: PersAFLConfig, delays,
                 strategy="persafl", schedule="immediate",
                 batch_size: int = 32, seed: int = 0,
                 vectorized: bool = True, cohort_impl: str = "auto",
                 scheduler: str = "auto", device="cuda", mesh=None,
                 param_shardings=None):
        if scheduler not in ("auto", "heap", "device"):
            raise ValueError(f"scheduler must be 'auto', 'heap' or "
                             f"'device', got {scheduler!r}")
        self.device = resolve_device(device)
        self.clients = clients
        self.pcfg = pcfg
        self.delays = delays
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.loss_fn = loss_fn
        self.strategy = resolve_strategy(strategy).bind(pcfg, loss_fn)
        self.schedule = resolve_schedule(schedule)
        self.scheduler = scheduler
        self.state = init_server_state(init_params, self.device)
        self.engine = CohortEngine(self.strategy.pcfg, loss_fn,
                                   vectorized=vectorized,
                                   cohort_impl=cohort_impl,
                                   strategy=self.strategy,
                                   device=self.device, mesh=mesh,
                                   param_shardings=param_shardings)
        self.state.params = self.engine.place_params(self.state.params)
        self._cstates: List = [None] * len(clients)
        self._on_eval: Optional[Callable] = None
        self._stop = False
        self.final_stats: Optional[Dict] = None
        self.scheduler_stats: Dict = {
            "scheduler": scheduler, "windows": 0, "cohort_fill_sum": 0,
            "cohort_fill_max": 0, "dropouts": 0, "corrupted_rows": 0,
            "robust_clipped": 0, "robust_trimmed": 0,
            "robust_nonfinite": 0}
        self.window_log: List[Dict] = []
        self._window_log_cap = 1024

    # -- shared plumbing ---------------------------------------------------

    @property
    def params(self):
        """The current global model w."""
        return self.state.params

    def _sample(self, i: int):
        return sample_batches(self.clients[i], self.rng,
                              3 * self.pcfg.q_local, self.batch_size)

    def _cstate_for_dispatch(self, i: int):
        if not self.strategy.stateful:
            return None
        if self._cstates[i] is None:
            self._cstates[i] = self.strategy.init_client_state(
                ctx.gather(self.state.params))
        return self.strategy.dispatch_state(self._cstates[i])

    def _write_back(self, client_ids: List[int], bank: DeltaBank) -> None:
        """Store the cohort's updated client states (rows gathered on the
        device) and run the strategy's shared-state fold (SCAFFOLD's
        c_global)."""
        if not self.strategy.stateful:
            return
        updates = []
        for row, i in enumerate(client_ids):
            new = bank.client_state(row)
            updates.append((i, self._cstates[i], new))
            self._cstates[i] = new
        self.strategy.post_round(updates, len(self.clients))

    @property
    def stats(self) -> Dict:
        """Engine + per-window scheduler counters in one dict."""
        s = dict(self.engine.stats)
        s.update(self.scheduler_stats)
        s["mean_cohort_fill"] = (
            self.scheduler_stats["cohort_fill_sum"]
            / max(self.scheduler_stats["windows"], 1))
        return s

    def _record_window(self, now: float, fill: int, taus: List[int],
                       **extra: int) -> None:
        """Per-server-apply bookkeeping: cohort fill, staleness spread and
        robust-admission actions; the first ``_window_log_cap`` windows
        also get a record in ``window_log``."""
        st = self.scheduler_stats
        st["windows"] += 1
        st["cohort_fill_sum"] += fill
        st["cohort_fill_max"] = max(st["cohort_fill_max"], fill)
        for key, val in extra.items():
            st[key] = st.get(key, 0) + val
        if len(self.window_log) < self._window_log_cap:
            self.window_log.append({
                "window": st["windows"], "time": float(now),
                "fill": int(fill),
                "tau_mean": float(np.mean(taus)) if taus else 0.0,
                "tau_max": int(max(taus)) if taus else 0,
                "dropouts": st["dropouts"],
                "corrupted_rows": st["corrupted_rows"], **extra})

    def _flush(self) -> None:
        """Materialize every pending client update in one cohort call.

        Called right before any server apply: params have not changed since
        these clients' downloads completed, so the whole cohort shares one
        snapshot.  Deltas are recorded as (DeltaBank, row) handles.

        Adversarial clients (a ChurnModel with an adversarial population)
        corrupt their rows here, right after the cohort computes them: one
        ``scale_rows`` pass over the bank on the device."""
        if not self._pending:
            return
        stateful = self.strategy.stateful
        bank = self.engine.update_cohort(
            self.state.params, [b for _, _, b, _ in self._pending],
            cstate_list=[c for _, _, _, c in self._pending]
            if stateful else None)
        ids = [i for _, i, _, _ in self._pending]
        factors = self.delays.corruption_factors(np.asarray(ids)) \
            if hasattr(self.delays, "corruption_factors") else None
        if factors is not None and bool(np.any(factors != 1.0)):
            vec = np.ones(bank.capacity, np.float32)
            vec[:len(ids)] = factors
            if bank._stacked is not None or bank._rows is None:
                bank._stacked = scale_rows(bank.stacked, vec)
            else:
                # per-event (vectorized=False) banks hold per-row trees
                bank._rows = [tree_map(lambda x, f=float(f): x * f, r)
                              for r, f in zip(bank._rows,
                                              vec[:len(bank._rows)])]
            self.scheduler_stats["corrupted_rows"] += \
                int(np.sum(factors != 1.0))
        for idx, (rid, _, _, _) in enumerate(self._pending):
            self._computed[rid] = (bank, idx)
        if stateful:
            self._write_back(ids, bank)
        self._pending = []

    def _record_eval(self, hist: History, now: float, eval_fn,
                     t: int, notify: bool = True) -> None:
        """Run one evaluation and append it to the History.  With
        ``notify=True`` a ``"stop"`` from the run's ``on_eval`` callback
        halts the loop after the current server apply."""
        acc, loss = _normalize_eval(eval_fn(ctx.gather(self.state.params)))
        hist.times.append(now)
        hist.rounds.append(int(t))
        hist.acc.append(acc)
        if loss is not None:
            hist.loss.append(loss)
        if notify and self._on_eval is not None \
                and self._on_eval(hist) == "stop":
            self._stop = True

    # -- the run surface ---------------------------------------------------

    def run(self, *, max_rounds: Optional[int] = None,
            max_server_rounds: Optional[int] = None,
            eval_every: Optional[int] = None,
            eval_fn: Optional[Callable] = None,
            record_active_every: float = 5.0,
            max_time: Optional[float] = None,
            on_eval: Optional[Callable[[History], Optional[str]]] = None,
            final_eval: bool = False) -> History:
        """Drive the run to ``max_rounds`` server rounds (or ``max_time``
        simulated seconds, whichever first) and return the :class:`History`.

        ``on_eval(hist)`` is called after every recorded evaluation;
        returning ``"stop"`` halts the loop cleanly.  ``final_eval=True``
        forces one evaluation at the stop time if the last one is stale.
        """
        if max_rounds is None:
            max_rounds = max_server_rounds
        if max_rounds is None:
            raise TypeError("run() needs max_rounds=")
        if eval_every is None:
            eval_every = self.schedule.default_eval_every
        self._on_eval = on_eval
        self._stop = False
        self.schedule.start(self)
        if self.schedule.kind == "round":
            hist = self._run_rounds(max_rounds, eval_every, eval_fn,
                                    record_active_every, max_time)
        else:
            hist = self._run_events(max_rounds, eval_every, eval_fn,
                                    record_active_every, max_time)
        if final_eval and eval_fn is not None:
            t_now = int(self.state.t)
            if not hist.rounds or hist.rounds[-1] != t_now:
                self._record_eval(hist, hist.end_time, eval_fn, t_now,
                                  notify=False)
        self.final_stats = {k: np.asarray(v) for k, v
                            in staleness_stats(self.state).items()}
        return hist

    # -- event-driven core (immediate / buffered schedules) ----------------

    def _run_events(self, max_rounds, eval_every, eval_fn,
                    record_active_every, max_time) -> History:
        hist = History()
        n = len(self.clients)
        mode = self.scheduler
        if mode == "auto":
            # the reference's switch; measured alone, the stream is the
            # faster source at every n from 30 up (chip_smoke.py (p))
            mode = "device" if n >= 4096 else "heap"
        self.scheduler_stats["scheduler"] = mode
        events = EventStream(self.delays).events() if mode == "device" \
            else heap_events(self.delays, n)
        now = 0.0
        next_active_t = 0.0
        busy_up = {i: None for i in range(n)}  # upload finish times
        inflight: Dict[int, Tuple[int, int]] = {}  # client -> (rid, version)
        # (rid, client, batches, dispatch-ready cstate or None)
        self._pending: List[Tuple[int, int, Dict, object]] = []
        self._computed: Dict[int, Tuple] = {}   # rid -> (DeltaBank, row)
        self._t = int(self.state.t)             # host-side round mirror
        next_rid = 0

        for now_e, i, kind, dropped, t_up in events:
            if self._t >= max_rounds:
                break
            if max_time is not None and now_e > max_time:
                # the event lies past the budget: it does not run, and the
                # clock stops at the budget
                now = max_time
                break
            now = now_e
            # record active ratio on a time grid: active = comp./uploading
            while next_active_t <= now:
                up_now = sum(1 for v in busy_up.values()
                             if v is not None and v > next_active_t)
                hist.active_times.append(next_active_t)
                hist.active_ratio.append(up_now / n)
                next_active_t += record_active_every
            if kind == 0:                       # download complete
                if dropped:
                    self.scheduler_stats["dropouts"] += 1
                    continue
                rid = next_rid
                next_rid += 1
                self._pending.append((rid, i, self._sample(i),
                                      self._cstate_for_dispatch(i)))
                busy_up[i] = t_up
                inflight[i] = (rid, self._t)
            else:                               # upload complete
                rid, version = inflight.pop(i)
                self.schedule.on_upload(self, now, rid, version, hist,
                                        eval_fn, eval_every)
                busy_up[i] = None
                if self._stop:
                    break
        # close out the active-ratio grid to the actual stop time
        while next_active_t <= now:
            up_now = sum(1 for v in busy_up.values()
                         if v is not None and v > next_active_t)
            hist.active_times.append(next_active_t)
            hist.active_ratio.append(up_now / n)
            next_active_t += record_active_every
        hist.end_time = now
        return hist

    # -- barrier-round core (sync_barrier schedule) ------------------------

    def _run_rounds(self, max_rounds, eval_every, eval_fn,
                    record_active_every, max_time) -> History:
        hist = History()
        n = len(self.clients)
        m = self.schedule.m
        now = 0.0
        next_active_t = 0.0
        for rnd in range(max_rounds):
            sel = self.rng.choice(n, m, replace=False)
            batches = [self._sample(int(i)) for i in sel]
            cstates = [self._cstate_for_dispatch(int(i)) for i in sel] \
                if self.strategy.stateful else None
            # the m sampled clients share the round's params: one cohort
            # call, deltas land in the bank, client state rides the stack
            bank = self.engine.update_cohort(self.state.params, batches,
                                             cstate_list=cstates)
            finish = [self.delays.sample_download(int(i), now)
                      + self.delays.sample_upload(int(i), now) for i in sel]
            round_len = max(finish)
            # active-ratio grid: client i is busy until its own finish time
            while next_active_t <= now + round_len:
                rel = next_active_t - now
                busy = sum(1 for f in finish if f > rel)
                hist.active_times.append(next_active_t)
                hist.active_ratio.append(busy / n)
                next_active_t += record_active_every
            now += round_len
            # the mean and the β-scaled apply fuse into one apply_rows pass
            # (weights = β/m on real rows, 0 on bucket padding); one server
            # round per barrier, staleness 0 by construction
            weights = np.zeros(bank.capacity, np.float32)
            weights[:len(batches)] = self.pcfg.beta / len(batches)
            self.state = apply_buffered_rows(self.state, bank.stacked,
                                             weights, 1, staleness_max=0,
                                             staleness_sum=0.0)
            self._write_back([int(i) for i in sel], bank)
            if eval_fn is not None and (rnd + 1) % eval_every == 0:
                self._record_eval(hist, now, eval_fn, rnd + 1)
            if self._stop or (max_time is not None and now >= max_time):
                break
        hist.end_time = now
        return hist
