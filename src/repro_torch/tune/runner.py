"""Arm executor, as in ``src/repro/tune/runner.py``: drives one
:class:`repro_torch.fl.FLRun` per :class:`Arm` on the runner's ``device`` (the
card unless the caller asks for the CPU), self-stopping through the
``on_eval`` hook, journaling one JSONL row per trial so a killed sweep
resumes by fingerprint skip.

The runner is problem-agnostic: the caller supplies a ``problem(arm)``
factory returning the concrete ingredients —

    {"clients": [...], "loss_fn": f, "init_params": tree,
     "eval_fn": eval, "pcfg": PersAFLConfig(...),        # base config
     "batch_size": 16, "eval_every": 20}                  # optional

— and the runner turns the arm's declarative fields into the live run:
strategy from the registry, schedule via
:func:`repro_torch.tune.space.parse_schedule`, ``PersAFLConfig`` overrides via
``dataclasses.replace``, delays from the arm's
:class:`~repro_torch.fl.scenario.ScenarioSpec` (or a plain
:class:`~repro_torch.fl.DelayModel` on the arm's seed).  Arms sharing a seed
replay *paired* client/delay streams: the counter-based hash streams of
:mod:`repro_torch.fl.delays` make every client's timeline a pure function of
(seed, client, cycle), so two arms differing only in strategy/schedule
see bit-identical event timelines and their scores differ only by what
the tuner varies (pinned in ``tests/test_torch_tune.py``).

Every finished arm appends a :class:`Trial` row to the journal
(``journal.jsonl``); re-running a sweep skips rows whose trial key —
arm fingerprint + stop-rule hash — is already present, so the marginal
cost of resuming is zero and a hillclimb ladder picks up mid-rung.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import PersAFLConfig
from repro_torch.fl.api import FLRun
from repro_torch.fl.delays import DelayModel
from repro_torch.tree import tree_leaves
from repro_torch.tune.space import Arm, parse_schedule, promote, rung_arms
from repro_torch.tune.stop import StopRule, rule_to_dict

# run.stats counters worth journaling per trial (scheduler + robustness
# observability; missing keys — e.g. on schedules without robust
# admission — are simply absent)
_STAT_KEYS = ("dropouts", "corrupted_rows", "robust_clipped",
              "robust_trimmed", "robust_nonfinite", "mean_cohort_fill",
              "windows")


@dataclasses.dataclass
class Trial:
    """One journaled arm execution (a JSONL row)."""
    key: str
    arm: Arm
    status: str                       # "completed" | "stopped"
    stop_reason: Optional[str]
    stop_rule: Optional[Dict]
    sim_time: float
    rounds: int
    final_acc: float
    final_loss: Optional[float]
    times: List[float]
    acc: List[float]
    loss: List[float]
    staleness_mean: float
    staleness_max: int
    host_materializations: int
    params_finite: bool
    stats: Dict
    wall_s: float
    resumed: bool = False

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["arm"] = self.arm.to_dict()
        return d

    @staticmethod
    def from_dict(d: Dict) -> "Trial":
        d = dict(d)
        d["arm"] = Arm.from_dict(d["arm"])
        return Trial(**d)

    @property
    def score(self) -> float:
        """The hillclimb promotion score (final accuracy; NaN sorts
        last in :func:`repro_torch.tune.space.promote`)."""
        return self.final_acc


def trial_key(arm: Arm, stop_rule: Optional[StopRule]) -> str:
    """Resume key: the arm fingerprint extended by the stop-rule hash —
    an exhaustive trial and a self-stopped trial of the same arm are
    different rows (the former is the latter's superset trace)."""
    fp = arm.fingerprint()
    if stop_rule is None:
        return fp
    blob = json.dumps(rule_to_dict(stop_rule), sort_keys=True)
    return fp + "-" + hashlib.sha256(blob.encode()).hexdigest()[:8]


class TuneRunner:
    """Executes arms against a ``problem`` factory with optional
    self-stopping and a resumable JSONL journal.

    ``stop_rule=None`` runs every arm to its full budget (the exhaustive
    grid); a :class:`repro_torch.tune.stop.StopRule` turns on self-stopping —
    the rule is checked on the live History after every recorded eval and
    a firing halts the event loop through ``FLRun.run(on_eval=...)``.
    """

    def __init__(self, problem: Callable[[Arm], Dict], *,
                 journal: Optional[str] = None,
                 stop_rule: Optional[StopRule] = None,
                 verbose: bool = False, device="cuda"):
        self.problem = problem
        self.device = device
        self.stop_rule = stop_rule
        self.journal = journal
        self.verbose = verbose
        self._done: Dict[str, Trial] = {}
        if journal and os.path.exists(journal):
            with open(journal) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    t = Trial.from_dict(json.loads(line))
                    self._done[t.key] = t

    # -- journal -----------------------------------------------------------

    def _journal_append(self, trial: Trial) -> None:
        if not self.journal:
            return
        os.makedirs(os.path.dirname(self.journal) or ".", exist_ok=True)
        with open(self.journal, "a") as f:
            f.write(json.dumps(trial.to_dict(), sort_keys=True) + "\n")

    @property
    def completed_keys(self) -> Tuple[str, ...]:
        return tuple(self._done)

    # -- execution ---------------------------------------------------------

    def run_arm(self, arm: Arm) -> Trial:
        """Execute one arm (or return its journaled record, marked
        ``resumed=True``, if this exact trial already completed)."""
        key = trial_key(arm, self.stop_rule)
        if key in self._done:
            prior = self._done[key]
            return dataclasses.replace(prior, resumed=True)

        prob = self.problem(arm)
        clients = prob["clients"]
        pcfg: PersAFLConfig = prob["pcfg"]
        if arm.pcfg:
            pcfg = dataclasses.replace(pcfg, **dict(arm.pcfg))
        delays = arm.scenario.build() if arm.scenario is not None \
            else DelayModel(len(clients), seed=arm.seed)
        from repro_torch.fl.api import strategy as make_strategy
        run = FLRun(clients=clients, loss_fn=prob["loss_fn"],
                    init_params=prob["init_params"], pcfg=pcfg,
                    delays=delays,
                    strategy=make_strategy(arm.strategy,
                                           **dict(arm.strategy_kwargs)),
                    schedule=parse_schedule(arm.schedule),
                    batch_size=prob.get("batch_size", 32), seed=arm.seed,
                    device=self.device)

        stop_reason: List[Optional[str]] = [None]
        on_eval = None
        if self.stop_rule is not None:
            def on_eval(hist, _rule=self.stop_rule):
                reason = _rule.check(hist)
                if reason is not None:
                    stop_reason[0] = reason
                    return "stop"
                return None

        t0 = time.time()
        hist = run.run(max_rounds=arm.max_rounds,
                       eval_every=prob.get("eval_every"),
                       eval_fn=prob["eval_fn"], max_time=arm.budget,
                       on_eval=on_eval, final_eval=True)
        wall = time.time() - t0

        stats = run.stats
        finite = all(bool(torch.isfinite(x).all())
                     for x in tree_leaves(run.state.params))
        trial = Trial(
            key=key, arm=arm,
            status="stopped" if stop_reason[0] is not None else "completed",
            stop_reason=stop_reason[0],
            stop_rule=rule_to_dict(self.stop_rule),
            sim_time=float(hist.end_time),
            rounds=int(run.final_stats["server_rounds"]),
            final_acc=hist.acc[-1] if hist.acc else float("nan"),
            final_loss=hist.loss[-1] if hist.loss else None,
            times=list(hist.times), acc=list(hist.acc),
            loss=list(hist.loss),
            staleness_mean=float(np.mean(hist.staleness))
            if hist.staleness else 0.0,
            staleness_max=int(max(hist.staleness))
            if hist.staleness else 0,
            host_materializations=int(stats["host_materializations"]),
            params_finite=bool(finite),
            stats={k: stats[k] for k in _STAT_KEYS if k in stats},
            wall_s=wall)
        self._done[key] = trial
        self._journal_append(trial)
        if self.verbose:
            print(f"trial,{arm.group},{arm.name},{trial.status},"
                  f"{trial.final_acc:.3f},{trial.sim_time:.0f},"
                  f"{trial.rounds},{trial.stop_reason or ''}", flush=True)
        return trial

    def run_sweep(self, arms: Sequence[Arm]) -> List[Trial]:
        return [self.run_arm(a) for a in arms]

    def run_hillclimb(self, arms: Sequence[Arm],
                      budgets: Sequence[float], *,
                      eta: float = 2.0,
                      max_rounds: Optional[int] = None
                      ) -> List[List[Trial]]:
        """Successive halving: run every survivor at each rung budget,
        promote the top ``ceil(n/eta)`` by final accuracy to the next
        (larger) budget.  Returns the per-rung trial lists; the last
        rung's best trial is the sweep winner.  Every (arm, budget) pair
        is its own journal row, so a killed ladder resumes mid-rung."""
        survivors = list(arms)
        rungs: List[List[Trial]] = []
        for li, budget in enumerate(budgets):
            trials = self.run_sweep(rung_arms(survivors, budget, max_rounds))
            rungs.append(trials)
            if li + 1 < len(budgets):
                survivors = promote([(t.arm, t.score) for t in trials],
                                    eta=eta)
        return rungs
