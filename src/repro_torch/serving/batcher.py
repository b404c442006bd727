"""Request queue + micro-batcher for personalization traffic, as in
``src/repro/serving/batcher.py``.

Batcher *modes* are the paper's personalization options: mode ``"B"`` is the
Per-FedAvg one-step MAML fine-tune, mode ``"C"`` the pFedMe Moreau-envelope
prox solve.  Each mode owns a :class:`repro_torch.fl.engine.CohortEngine`
driven by ``strategy("personalize", mode=...)``, whose ``local_update``
computes the *personalization delta* (``head = w − delta``), so concurrent
users ride the pow2-bucketed cohort machinery of training and the bank rows
double as the server-side update direction.

Fairness: ``user_cap`` bounds how many of one user's rows are admitted per
aggregation window; over-cap requests are refused before they take a cohort
slot (``status="capped"``) and counted in ``stats["fairness_capped"]``.

Under ``cohort_impl="shard_map"`` the batcher lays the cohort out
cohort-slice-major: user ``u`` always takes a slot in cohort slice
``crc32(u) % n_slices``, where ``n_slices`` is the mesh's cohort-axis size,
so the user's delta row lands on the same slice every window.  Per-slice
slots pad to a common pow2 (counted in ``stats["shard_padding"]``), which
is the engine's slice-multiple bucket.  The ``placed`` list a drain yields
stays in SUBMIT order: the admission order the ring hands to the ordered
window apply, the same on every mesh layout.  With one slice a drain's rows
are its requests in submit order.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.types import PersAFLConfig
from repro_torch.fl.api import strategy as _strategy
from repro_torch.fl.engine import CohortEngine, DeltaBank

MODES = ("B", "C")


def personalize_strategy(pcfg: PersAFLConfig, loss_fn: Callable, mode: str,
                         personal_subset=None):
    """The bound ``strategy("personalize", mode=...)`` behind one batcher
    mode.  With ``personal_subset`` set, the delta covers only the personal
    leaves (pruned subset structure; backbone frozen)."""
    return _strategy("personalize", mode=mode,
                     personal_subset=personal_subset).bind(pcfg, loss_fn)


def __getattr__(name: str):
    if name == "personalize_delta_fn":
        raise ImportError(
            "repro_torch.serving.batcher.personalize_delta_fn was removed; "
            "use repro_torch.fl.api.strategy('personalize', mode=...) / "
            "personalize_strategy instead.")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class Ticket:
    """Submit/poll handle for one personalization request.

    A "done" ticket carries its OWN result handle: ``head`` is the (heads
    bank, row) pair its flush produced and ``window`` the ring window it was
    served in, so polling an older ticket after a newer flush returns that
    ticket's head.
    """
    user: object
    mode: str
    stamp: int                 # ring window the request was submitted in
    status: str = "queued"     # queued | done | dropped | capped
    tau: int = 0               # staleness in windows, set at drain time
    window: int = -1           # ring window the ticket was SERVED in
    head: Optional[tuple] = dataclasses.field(  # (heads bank, row)
        default=None, repr=False, compare=False)


def _pow2(k: int) -> int:
    return 1 << max(k - 1, 0).bit_length()


class MicroBatcher:
    """Coalesces concurrent personalization requests into cohort calls.

    Requests queue until :meth:`drain`, which groups them by ``(mode,
    stamp)`` (every group shares one params snapshot) and emits one
    ``update_cohort`` per group.  Straggler groups (stamp < current window)
    are computed against their *stamped* snapshot.
    """

    def __init__(self, engines: Dict[str, CohortEngine],
                 n_shards: int = 1, user_cap: Optional[int] = None):
        self.engines = engines
        self.n_shards = max(int(n_shards), 1)
        self.user_cap = user_cap
        self._queue: List[Tuple[Ticket, Dict]] = []
        # per-user rows admitted to the window currently accumulating
        self._cap_window: int = -1
        self._user_rows: Dict[object, int] = {}
        self.stats = {"submitted": 0, "drains": 0, "cohort_calls": 0,
                      "max_coalesced": 0, "shard_padding": 0, "dropped": 0,
                      "fairness_capped": 0}

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, ticket: Ticket, batch) -> Ticket:
        if ticket.mode not in self.engines:
            raise ValueError(f"mode {ticket.mode!r} not enabled; "
                             f"have {sorted(self.engines)}")
        self.stats["submitted"] += 1
        self._queue.append((ticket, batch))
        return ticket

    def _shard(self, user) -> int:
        return zlib.crc32(str(user).encode()) % self.n_shards

    def _layout(self, reqs: List[Tuple[Ticket, Dict]]):
        """Slice-major cohort layout -> (batch_list, [(ticket, row)]), as the
        reference's.  With one cohort slice the engine's tail padding does;
        with N the per-slice slot count pads to a pow2, so the total is the
        engine's slice-multiple bucket (row i on cohort slice i //
        per_slice).  ``placed`` is in SUBMIT order whichever slice each
        request landed on."""
        if self.n_shards == 1:
            return ([b for _, b in reqs],
                    [(t, i) for i, (t, _) in enumerate(reqs)])
        shards: List[List[Tuple[int, Dict]]] = \
            [[] for _ in range(self.n_shards)]
        for qi, (t, b) in enumerate(reqs):
            shards[self._shard(t.user)].append((qi, b))
        per = _pow2(max(len(s) for s in shards))
        fill = reqs[-1][1]
        batch_list, row_of = [], {}
        for si, s in enumerate(shards):
            for j in range(per):
                if j < len(s):
                    qi, b = s[j]
                    batch_list.append(b)
                    row_of[qi] = si * per + j
                else:
                    batch_list.append(fill)
                    self.stats["shard_padding"] += 1
        return batch_list, [(t, row_of[qi])
                            for qi, (t, _) in enumerate(reqs)]

    def drain(self, current: int, snapshot_fn: Callable[[int], object], *,
              tau_max: int) -> Iterator[Tuple[str, int, DeltaBank,
                                              List[Tuple[Ticket, int]]]]:
        """Yield ``(mode, stamp, bank, [(ticket, row), ...])`` per group,
        oldest stamp first.

        Requests whose staleness ``current − stamp`` exceeds ``tau_max`` are
        marked ``dropped`` without a cohort slot; with ``user_cap`` set, a
        user's requests past the cap within one window are refused the same
        way (``status="capped"``).
        """
        queue, self._queue = self._queue, []
        if not queue:
            return
        if current != self._cap_window:        # window rolled: caps reset
            self._cap_window = current
            self._user_rows = {}
        self.stats["drains"] += 1
        self.stats["max_coalesced"] = max(self.stats["max_coalesced"],
                                          len(queue))
        groups: Dict[Tuple[str, int], List[Tuple[Ticket, Dict]]] = {}
        for ticket, batch in queue:
            ticket.tau = current - ticket.stamp
            if ticket.tau > tau_max:
                ticket.status = "dropped"
                self.stats["dropped"] += 1
                continue
            if self.user_cap is not None:
                used = self._user_rows.get(ticket.user, 0)
                if used >= self.user_cap:
                    ticket.status = "capped"
                    self.stats["fairness_capped"] += 1
                    continue
                self._user_rows[ticket.user] = used + 1
            groups.setdefault((ticket.mode, ticket.stamp), []).append(
                (ticket, batch))
        for (mode, stamp), reqs in sorted(groups.items(),
                                          key=lambda kv: kv[0][1]):
            batch_list, placed = self._layout(reqs)
            self.stats["cohort_calls"] += 1
            bank = self.engines[mode].update_cohort(snapshot_fn(stamp),
                                                    batch_list)
            yield mode, stamp, bank, placed
