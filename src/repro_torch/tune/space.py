"""Declarative sweep space: JSON-round-tripping :class:`SweepSpec` →
fingerprinted :class:`Arm`\\ s, plus the successive-halving ``hillclimb``
expansion, as in ``src/repro/tune/space.py`` (an arm's fingerprint is the
reference's for the same arm).

A sweep is a cartesian grid over the run surfaces the Strategy registry
and :class:`repro_torch.fl.FLRun` already make one-liners:

  * **strategies** — registry names plus constructor kwargs
    (``{"name": "persafl", "option": "B"}``, ``{"name": "fedprox",
    "mu": 0.1}``);
  * **schedules** — spelled as strings (``"immediate"``, ``"buffered(8)"``,
    ``"buffered(8, robust=clip)"``, ``"sync(10)"``) so specs stay plain
    data; :func:`parse_schedule` turns a spelling into the live
    :class:`repro_torch.fl.api.ApplyPolicy`;
  * **pcfg_grid** — axes over :class:`repro_torch.core.PersAFLConfig` fields
    (``{"eta": [0.002, 0.005]}``);
  * an optional :class:`repro_torch.fl.scenario.ScenarioSpec` (churn /
    adversaries) shared by every arm;
  * **seeds** — one arm per seed; arms with equal seeds replay *paired*
    client/delay streams (the counter-based hash streams of
    :mod:`repro_torch.fl.delays` make timelines a pure function of (seed,
    client, cycle), so two arms differing only in strategy/schedule see
    bit-identical event timelines — what makes grid cells comparable).

:meth:`SweepSpec.arms` expands the grid into :class:`Arm` records, each
with a stable content :meth:`~Arm.fingerprint` — the resume key the
:class:`repro_torch.tune.runner.TuneRunner` journal skips completed trials by.

``hillclimb`` (successive halving): :func:`rung_arms` re-budgets a
surviving population onto the next rung, :func:`promote` keeps the top
``ceil(n/eta)`` scored arms.  Because an :class:`Arm`'s fingerprint
covers its budget, every (arm, rung) pair is its own journaled trial and
a killed hillclimb resumes mid-ladder.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fl.api import (ApplyPolicy, buffered, immediate, strategy,
                          sync_barrier)
from repro_torch.fl.scenario import ScenarioSpec

# ---------------------------------------------------------------------------
# schedule spellings
# ---------------------------------------------------------------------------

_SCHED_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z_0-9]*)\s*(?:\((.*)\))?\s*$")


def _literal(tok: str):
    """Parse one schedule-argument token: int, float, bool, None, or a
    (possibly quoted) bare string — ``robust=clip`` and ``robust='clip'``
    mean the same thing."""
    t = tok.strip()
    low = t.lower()
    if low in ("none", "null"):
        return None
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    return t


def parse_schedule(spelling: str) -> ApplyPolicy:
    """``"immediate"`` / ``"buffered(8)"`` / ``"buffered(4, robust=clip,
    trim_frac=0.2)"`` / ``"sync(10)"`` → a fresh :class:`ApplyPolicy`.

    Every call constructs a new policy instance (policies hold per-run
    state), so one spelling can drive many arms.
    """
    m = _SCHED_RE.match(spelling)
    if not m:
        raise ValueError(f"unparseable schedule spelling {spelling!r}")
    name, argstr = m.group(1), m.group(2)
    args: List = []
    kwargs: Dict = {}
    if argstr and argstr.strip():
        for tok in argstr.split(","):
            if "=" in tok:
                k, v = tok.split("=", 1)
                kwargs[k.strip()] = _literal(v)
            else:
                args.append(_literal(tok))
    factories = {"immediate": immediate, "buffered": buffered,
                 "sync": sync_barrier, "sync_barrier": sync_barrier}
    try:
        factory = factories[name]
    except KeyError:
        raise ValueError(f"unknown schedule {name!r}; "
                         f"have {sorted(factories)}") from None
    return factory(*args, **kwargs)


# ---------------------------------------------------------------------------
# Arm
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Arm:
    """One fully-specified grid cell: everything the runner needs to build
    and drive an :class:`repro_torch.fl.FLRun`, as plain data.

    ``budget`` is the arm's simulated-time budget (``FLRun(max_time=)``);
    ``max_rounds`` the generous round cap that keeps time — not rounds —
    the binding constraint.  ``group`` is a free-form report-grouping key
    (typically the dataset name plus the grid the arm belongs to).
    """
    strategy: str
    strategy_kwargs: Tuple[Tuple[str, object], ...] = ()
    schedule: str = "immediate"
    pcfg: Tuple[Tuple[str, object], ...] = ()
    scenario: Optional[ScenarioSpec] = None
    seed: int = 0
    budget: Optional[float] = None
    max_rounds: int = 100
    group: str = ""

    def __post_init__(self):
        # dict spellings are friendlier at call sites; store as sorted
        # item-tuples so the dataclass stays hashable/frozen
        for f in ("strategy_kwargs", "pcfg"):
            v = getattr(self, f)
            if isinstance(v, dict):
                object.__setattr__(self, f, tuple(sorted(v.items())))
            else:
                object.__setattr__(self, f, tuple(tuple(kv) for kv in v))
        parse_schedule(self.schedule)      # fail at expansion, not mid-sweep
        strategy(self.strategy, **dict(self.strategy_kwargs))

    @property
    def name(self) -> str:
        kw = ",".join(f"{k}={v}" for k, v in self.strategy_kwargs)
        return (f"{self.strategy}({kw})" if kw else self.strategy) \
            + f"/{self.schedule}" \
            + (f"/seed{self.seed}" if self.seed else "")

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["strategy_kwargs"] = dict(self.strategy_kwargs)
        d["pcfg"] = dict(self.pcfg)
        d["scenario"] = json.loads(self.scenario.to_json()) \
            if self.scenario is not None else None
        return d

    @staticmethod
    def from_dict(d: Dict) -> "Arm":
        d = dict(d)
        if d.get("scenario") is not None:
            d["scenario"] = ScenarioSpec.from_json(json.dumps(d["scenario"]))
        return Arm(**d)

    def fingerprint(self) -> str:
        """Stable content hash over the arm's canonical JSON — the
        journal's resume key.  Covers the budget: the same configuration
        at a larger hillclimb rung is a different trial."""
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def with_budget(self, budget: Optional[float],
                    max_rounds: Optional[int] = None) -> "Arm":
        """The same configuration at a different simulated-time budget
        (hillclimb promotion re-fingerprints through this)."""
        return dataclasses.replace(
            self, budget=budget,
            max_rounds=self.max_rounds if max_rounds is None else max_rounds)


# ---------------------------------------------------------------------------
# SweepSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The declarative sweep grid (see module docstring).  ``strategies``
    entries are ``{"name": ..., **ctor_kwargs}`` dicts; ``pcfg`` holds
    shared :class:`PersAFLConfig` overrides and ``pcfg_grid`` per-field
    axes the grid products over."""
    strategies: Tuple[Dict, ...]
    schedules: Tuple[str, ...] = ("immediate",)
    pcfg: Tuple[Tuple[str, object], ...] = ()
    pcfg_grid: Tuple[Tuple[str, Tuple], ...] = ()
    scenario: Optional[ScenarioSpec] = None
    seeds: Tuple[int, ...] = (0,)
    group: str = ""

    def __post_init__(self):
        if not self.strategies:
            raise ValueError("need at least one strategy")
        if not self.schedules:
            raise ValueError("need at least one schedule")
        if not self.seeds:
            raise ValueError("need at least one seed")
        object.__setattr__(self, "strategies",
                           tuple(dict(s) for s in self.strategies))
        for s in self.strategies:
            if "name" not in s:
                raise ValueError(f"strategy entry {s} lacks 'name'")
        for f in ("pcfg",):
            v = getattr(self, f)
            if isinstance(v, dict):
                object.__setattr__(self, f, tuple(sorted(v.items())))
        g = self.pcfg_grid
        if isinstance(g, dict):
            object.__setattr__(
                self, "pcfg_grid",
                tuple(sorted((k, tuple(vs)) for k, vs in g.items())))
        else:
            object.__setattr__(
                self, "pcfg_grid",
                tuple((k, tuple(vs)) for k, vs in g))
        object.__setattr__(self, "schedules", tuple(self.schedules))
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))

    # -- JSON round-trip ---------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["pcfg"] = dict(self.pcfg)
        d["pcfg_grid"] = {k: list(vs) for k, vs in self.pcfg_grid}
        d["scenario"] = json.loads(self.scenario.to_json()) \
            if self.scenario is not None else None
        return json.dumps(d, indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "SweepSpec":
        d = json.loads(s)
        if d.get("scenario") is not None:
            d["scenario"] = ScenarioSpec.from_json(json.dumps(d["scenario"]))
        d["strategies"] = tuple(d["strategies"])
        d["schedules"] = tuple(d["schedules"])
        d["seeds"] = tuple(d["seeds"])
        d["pcfg"] = d.get("pcfg", {})
        d["pcfg_grid"] = d.get("pcfg_grid", {})
        return SweepSpec(**d)

    # -- expansion ---------------------------------------------------------

    def arms(self, *, max_rounds: int,
             budget: Optional[float] = None) -> List[Arm]:
        """Expand the grid: strategies × schedules × pcfg_grid × seeds,
        every cell a fingerprinted :class:`Arm` at the given budget."""
        grid_keys = [k for k, _ in self.pcfg_grid]
        grid_vals = [vs for _, vs in self.pcfg_grid]
        out = []
        for strat, sched, combo, seed in itertools.product(
                self.strategies, self.schedules,
                itertools.product(*grid_vals) if grid_vals else [()],
                self.seeds):
            skw = {k: v for k, v in strat.items() if k != "name"}
            pc = dict(self.pcfg)
            pc.update(zip(grid_keys, combo))
            out.append(Arm(strategy=strat["name"], strategy_kwargs=skw,
                           schedule=sched, pcfg=pc, scenario=self.scenario,
                           seed=seed, budget=budget, max_rounds=max_rounds,
                           group=self.group))
        return out


# ---------------------------------------------------------------------------
# hillclimb (successive halving)
# ---------------------------------------------------------------------------

def promote(scored: Sequence[Tuple[Arm, float]],
            eta: float = 2.0) -> List[Arm]:
    """Keep the top ``ceil(n/eta)`` arms by score (descending; ties break
    deterministically on the arm name, then fingerprint).  Always keeps at
    least one arm; non-finite scores (a diverged rung trial) sort last."""
    if not scored:
        return []
    keep = max(1, math.ceil(len(scored) / float(eta)))

    def key(pair):
        arm, score = pair
        finite = isinstance(score, (int, float)) and math.isfinite(score)
        return (-(score if finite else float("-inf")),
                arm.name, arm.fingerprint())

    return [arm for arm, _ in sorted(scored, key=key)[:keep]]


def rung_arms(arms: Sequence[Arm], budget: Optional[float],
              max_rounds: Optional[int] = None) -> List[Arm]:
    """Re-budget a surviving population onto the next rung (each result is
    a fresh fingerprint — its own resumable trial)."""
    return [a.with_budget(budget, max_rounds) for a in arms]
