"""Persistent DeltaBank ring-buffer (the serving-side bank), as in
``src/repro/serving/bank.py``.

A serving deployment has no end of run: traffic arrives forever and the
global model advances in aggregation *windows*.  :class:`DeltaRing` keeps
the banks AND the params snapshot of the last ``windows`` windows alive on
the device:

  * a row admitted with staleness τ > 0 (a straggler stamped in an earlier
    window) is folded into the *current* window's weight vector through
    :func:`repro_torch.core.admission_weights` (β/M with damping
    ``(1+τ)^{-a}``); rows staler than ``tau_max`` are dropped and counted;
  * the window apply goes through :func:`repro_torch.core.apply_admitted_rows`
    once per contributing bank, in admission order, and leaves the
    pre-apply params intact as the closed window's snapshot.

On a mesh (the server's ``cohort_impl="shard_map"``) banks, head banks and
snapshots are stored as the params are placed: DTensors whose rows split
over "cohort" and whose model dims follow the params' shardings (a demoted
int8 snapshot is kept whole).

Partial-model personalization (``subset=``): banked rows and retained
snapshots hold only the personal leaves; the shared backbone is stored once
(``_base``) and recombined on demand.  This is exact: subset applies never
touch backbone leaves.

Int8 delta banking (``delta_dtype="int8"``): retained banks arrive as
:class:`repro_torch.core.quant.QuantizedBank` handles (the server's flush
quantizes with per-user error feedback) and the window apply sends their
:class:`QuantStack` to the ``apply_rows_q`` kernel.  The ring also demotes
the just-closed window's snapshot (personal leaves) to a
:class:`QuantTree`; the current snapshot stays exact, and older ones
dequantize on access for straggler recomputes.  ``row_nbytes`` counts the
quantized bytes, ``row_nbytes_fp32`` the fp32 baseline.

:meth:`DeltaRing.load` restores snapshots, window counter and cumulative
stats after a restart; banks and pending admissions are not persisted.
The per-user lookups (:meth:`DeltaRing.lookup`,
:meth:`DeltaRing.admitted_rows`) serve the socket front-end,
:mod:`repro_torch.serving.transport`.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

from repro_torch.core import (admission_weights, apply_admitted_rows,
                              mask_rows, robust_flush_weights)
from repro_torch.core.quant import (QuantStack, QuantTree, dequantize_tree,
                                    fp32_row_nbytes, quantize_tree)
from repro_torch.core.subset import SubsetSpec, merge_subset
from repro_torch.core.subset import row_nbytes as _row_nbytes
from repro_torch.core.types import ServerState
from repro_torch.fl.engine import DeltaBank
from repro_torch.sharding.ctx import gather


class DeltaRing:
    """Ring of the last ``windows`` aggregation windows of stacked deltas.

    :meth:`retain` has the shape of a :meth:`CohortEngine.add_bank_hook`
    callback; :meth:`admit_row` marks a (bank, row) as contributing to the
    next apply; :meth:`advance` closes the window with one stacked apply per
    contributing bank.
    """

    def __init__(self, params0, *, windows: int = 4,
                 tau_max: Optional[int] = None,
                 user_cap: Optional[int] = None, subset=None,
                 delta_dtype: str = "fp32",
                 robust: Optional[str] = None,
                 clip_norm: Optional[float] = None,
                 trim_frac: float = 0.1):
        if windows < 1:
            raise ValueError("need at least one retained window")
        if delta_dtype not in ("fp32", "int8"):
            raise ValueError(f"delta_dtype must be 'fp32' or 'int8', "
                             f"got {delta_dtype!r}")
        if robust not in (None, "clip", "trim"):
            raise ValueError(f"robust must be None, 'clip' or 'trim', "
                             f"got {robust!r}")
        self.delta_dtype = delta_dtype
        self.robust = robust
        self.clip_norm = clip_norm
        self.trim_frac = trim_frac
        self.windows = windows
        # a straggler can only be recomputed against a retained snapshot, so
        # the effective bound never exceeds the ring depth; the REQUESTED
        # value is kept for checkpoints (a deeper ring widens back to it)
        self.tau_max_requested = int(tau_max) if tau_max is not None \
            else windows - 1
        if tau_max is not None and tau_max > windows - 1:
            warnings.warn(
                f"tau_max={tau_max} exceeds the ring depth; clamped to "
                f"{windows - 1} (a straggler can only be recomputed against "
                f"a retained snapshot).  The requested value is preserved "
                f"for checkpoint round-trips.", stacklevel=2)
        self.tau_max = min(self.tau_max_requested, windows - 1)
        self.user_cap = user_cap
        self.subset = SubsetSpec.resolve(subset, params0)
        self._base = params0
        self.row_nbytes: Optional[int] = None  # set at first retained bank
        self.row_nbytes_fp32: Optional[int] = None
        self.current = 0
        self._snapshots: Dict[int, object] = {0: self._store(params0)}
        self._banks: Dict[int, List[DeltaBank]] = {0: []}
        # (bank, row, τ) admitted to the window currently accumulating
        self._pending: List[Tuple[DeltaBank, int, int]] = []
        # user -> rows admitted to the accumulating window (fairness cap)
        self._user_rows: Dict[object, int] = {}
        # user -> (window, bank, row) of the user's latest admitted delta
        self._by_user: Dict[object, Tuple[int, DeltaBank, int]] = {}
        self.stats = {"windows": 0, "admitted": 0, "stragglers": 0,
                      "dropped": 0, "fairness_capped": 0,
                      "robust_clipped": 0, "robust_trimmed": 0,
                      "robust_nonfinite": 0}

    # -- retention ---------------------------------------------------------

    def _store(self, params):
        """What a window snapshot retains: the personal subset (pruned tree)
        in subset mode, the full params otherwise."""
        return self.subset.extract(params) if self.subset is not None \
            else params

    def _thaw(self, snap):
        return dequantize_tree(snap) if isinstance(snap, QuantTree) else snap

    def snapshot(self, window: int):
        """FULL params the given window's cohorts were computed against."""
        snap = self._thaw(self._snapshots[window])
        if self.subset is not None:
            return merge_subset(self._base, snap)
        return snap

    def subset_snapshot(self, window: int):
        """The window's snapshot in stored structure (the pruned subset tree
        in subset mode), dequantized when the window was demoted."""
        return self._thaw(self._snapshots[window])

    def retain(self, bank) -> None:
        """Bank-handoff hook: pin ``bank`` (a DeltaBank or a QuantizedBank)
        to the current window."""
        self._banks[self.current].append(bank)
        if self.row_nbytes is None and len(bank):
            self.row_nbytes = _row_nbytes(bank.stacked)
            self.row_nbytes_fp32 = (
                fp32_row_nbytes(bank.stacked)
                if isinstance(bank.stacked, QuantStack)
                else self.row_nbytes)

    def lookup(self, user):
        """-> (window, bank, row) of the user's latest admitted delta, or
        None once the row's window has retired from the ring."""
        return self._by_user.get(user)

    def admitted_rows(self, user) -> int:
        """Rows this user already has admitted into the accumulating
        window: the consumed share of the ``user_cap`` budget, which the
        transport consults to refuse over-cap work at the door."""
        return self._user_rows.get(user, 0)

    @property
    def live_banks(self) -> int:
        return sum(len(b) for b in self._banks.values())

    # -- admission ---------------------------------------------------------

    def admit_row(self, user, bank: DeltaBank, row: int, tau: int) -> str:
        """Admit one delta row into the accumulating window's apply; returns
        ``"admitted"``, ``"dropped"`` (τ past ``tau_max``) or ``"capped"``
        (past the per-window ``user_cap``)."""
        if tau > self.tau_max:
            self.stats["dropped"] += 1
            return "dropped"
        if self.user_cap is not None \
                and self._user_rows.get(user, 0) >= self.user_cap:
            self.stats["fairness_capped"] += 1
            return "capped"
        if tau > 0:
            self.stats["stragglers"] += 1
        self.stats["admitted"] += 1
        self._user_rows[user] = self._user_rows.get(user, 0) + 1
        self._pending.append((bank, row, tau))
        self._by_user[user] = (self.current, bank, row)
        return "admitted"

    def admit(self, user, bank: DeltaBank, row: int, tau: int) -> bool:
        """Boolean wrapper over :meth:`admit_row`."""
        return self.admit_row(user, bank, row, tau) == "admitted"

    # -- window boundary ---------------------------------------------------

    def advance(self, state: ServerState, *, beta: float,
                damping: float = 0.0) -> ServerState:
        """Close the accumulating window: apply every admitted row and
        rotate the ring.

        One stacked apply per contributing bank, in the order the banks
        were first admitted from; the weights fold β/M, per-row damping and
        padding masks (:func:`admission_weights`, shared with the buffered
        schedule) or, with ``robust`` set, the window-wide robust weights.
        Each apply gets the window's admission order (submit order, by the
        batcher's contract): on a bank that spans devices the rows
        accumulate in that order, so the post-advance params are the same
        bits on the 1-D and 2-D mesh layouts although the two place users
        at different rows.  Returns the post-apply state; the pre-apply
        params become the closed window's snapshot.
        """
        m = len(self._pending)
        if m:
            groups: Dict[int, Tuple[DeltaBank, List[Tuple[int, int]]]] = {}
            for bank, row, tau in self._pending:
                groups.setdefault(id(bank), (bank, []))[1].append((row, tau))
            if self.robust is not None:
                # one call for the whole window: the defense calibrates over
                # every pending admission, straggler banks included
                per_bank, info = robust_flush_weights(
                    groups, beta=beta, count=m, damping=damping,
                    tau_max=self.tau_max, method=self.robust,
                    clip_norm=self.clip_norm, trim_frac=self.trim_frac)
                for key in ("clipped", "trimmed", "nonfinite"):
                    self.stats[f"robust_{key}"] += info[key]
            for key, (bank, rows) in groups.items():
                if self.robust is not None:
                    weights, keep = per_bank[key]
                    stack = bank.stacked if bool(keep.all()) \
                        else mask_rows(bank.stacked, keep)
                else:
                    weights = admission_weights(
                        bank.capacity, rows, beta=beta, count=m,
                        damping=damping, tau_max=self.tau_max)
                    stack = bank.stacked
                # admission order, deduped (a twice-admitted row already
                # carries its summed weight), then the zero-weight rest: a
                # full permutation for the ordered apply of a sharded bank
                order = list(dict.fromkeys(r for r, _ in rows))
                seen = set(order)
                order.extend(r for r in range(bank.capacity)
                             if r not in seen)
                state = apply_admitted_rows(
                    state, stack, weights, len(rows),
                    staleness_max=max(t for _, t in rows),
                    staleness_sum=float(sum(t for _, t in rows)),
                    order=order)
        self._pending = []
        self._user_rows = {}
        self.stats["windows"] += 1
        self.current += 1
        self._base = state.params
        self._snapshots[self.current] = self._store(state.params)
        self._banks[self.current] = []
        if self.delta_dtype == "int8":
            # demote the just-closed window's snapshot: only stragglers read
            # it again, and their deltas are int8 anyway
            prev = self.current - 1
            if prev in self._snapshots \
                    and not isinstance(self._snapshots[prev], QuantTree):
                # (whole: a placed snapshot is gathered first)
                self._snapshots[prev] = quantize_tree(
                    gather(self._snapshots[prev]))
        horizon = self.current - self.windows + 1
        for w in [w for w in self._snapshots if w < horizon]:
            del self._snapshots[w]
            self._banks.pop(w, None)
        for user in [u for u, (w, _, _) in self._by_user.items()
                     if w < horizon]:
            del self._by_user[user]
        return state

    # -- restart warm-start ------------------------------------------------

    def load(self, snapshots: Dict[int, object], current: int,
             stats: Optional[Dict[str, int]] = None) -> None:
        """Warm-start after a restart: install checkpointed snapshots, the
        window counter and the cumulative ``stats`` (engine and batcher
        stats are process-local and start at zero).  Banks, pending
        admissions and per-user rows start empty.  Without ``stats``,
        ``windows`` falls back to ``current``."""
        if current not in snapshots:
            raise ValueError(f"current window {current} has no snapshot")
        horizon = current - self.windows + 1
        self.current = current
        self._snapshots = {w: s for w, s in snapshots.items()
                           if w >= horizon}
        self._banks = {w: [] for w in self._snapshots}
        self._pending = []
        self._user_rows = {}
        self._by_user = {}
        if stats is not None:
            self.stats.update({k: int(v) for k, v in stats.items()
                               if k in self.stats})
        else:
            self.stats["windows"] = current
