"""Early-stop rules: pure predicates over the live run trace, a copy of
``src/repro/tune/stop.py``.

A :class:`StopRule` looks only at the trace recorded so far — the
``acc`` / ``loss`` series of a :class:`repro_torch.fl.History` (any object with
those two list attributes works, which is what makes the rules unit-
testable against hand-built traces).  :meth:`StopRule.check` returns a
human-readable reason string when the rule fires and ``None`` otherwise;
rules never mutate the trace and hold no state, so re-checking a longer
trace is always consistent with having watched it grow.

The three families (the wandb-style convergence-watch idiom):

  * :class:`MedianLoss` — the running-median loss rule: fire when the
    latest eval loss is ``factor``× worse than the running median of the
    recent window.  Catches slow divergence and loss creep that a simple
    best-so-far test misses.
  * :class:`LossSpike` — the divergence abort: fire the moment the loss
    goes non-finite or jumps ``factor``× above the best loss seen.
  * :class:`AccPlateau` — patience on accuracy: fire when the best
    accuracy of the last ``patience`` evals fails to improve on the best
    before them by ``min_delta`` (a monotone improver with a real slope
    never trips it).

Rules compose with :class:`AnyOf` and serialize to/from plain dicts
(:func:`rule_to_dict` / :func:`rule_from_dict`) so a sweep's exact stop
configuration is journaled into every trial record it killed.

Losses are assumed non-negative (cross-entropy-like); the multiplicative
thresholds are meaningless for signed objectives.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, Optional, Tuple


class StopRule:
    """Base: ``check(trace) -> reason-or-None``.  ``trace`` needs ``.acc``
    and ``.loss`` list attributes (a :class:`repro_torch.fl.History` or any
    stand-in)."""

    kind = "base"

    def check(self, trace) -> Optional[str]:
        raise NotImplementedError

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self) if dataclasses.is_dataclass(self) \
            else {}
        d["kind"] = self.kind
        return d


@dataclasses.dataclass(frozen=True)
class MedianLoss(StopRule):
    """Fire when the latest loss exceeds ``factor`` × the running median
    of the previous ``window`` losses (after ``warmup`` evals — early
    noise must not kill an arm that has not settled yet)."""

    window: int = 8
    factor: float = 1.3
    warmup: int = 4
    kind = "median_loss"

    def check(self, trace) -> Optional[str]:
        loss = trace.loss
        if len(loss) <= max(self.warmup, 1):
            return None
        prev = loss[-(self.window + 1):-1]
        finite = [x for x in prev if math.isfinite(x)]
        if not finite:
            return None                  # LossSpike owns the NaN case
        med = statistics.median(finite)
        if math.isfinite(loss[-1]) and loss[-1] > self.factor * med:
            return (f"median_loss: loss {loss[-1]:.4g} > {self.factor}x "
                    f"running median {med:.4g}")
        return None


@dataclasses.dataclass(frozen=True)
class LossSpike(StopRule):
    """Fire on divergence: a non-finite loss, or a loss ``factor``× above
    the best (minimum) loss seen so far."""

    factor: float = 3.0
    warmup: int = 1
    kind = "loss_spike"

    def check(self, trace) -> Optional[str]:
        loss = trace.loss
        if not loss:
            return None
        if not math.isfinite(loss[-1]):
            return f"loss_spike: non-finite loss at eval {len(loss)}"
        if len(loss) <= self.warmup:
            return None
        best = min(x for x in loss[:-1] if math.isfinite(x)) \
            if any(math.isfinite(x) for x in loss[:-1]) else None
        if best is not None and best > 0 and loss[-1] > self.factor * best:
            return (f"loss_spike: loss {loss[-1]:.4g} > {self.factor}x "
                    f"best {best:.4g}")
        return None


@dataclasses.dataclass(frozen=True)
class AccPlateau(StopRule):
    """Fire when accuracy has plateaued: the best of the last ``patience``
    evals improves on the best before them by less than ``min_delta``."""

    patience: int = 5
    min_delta: float = 0.003
    kind = "acc_plateau"

    def check(self, trace) -> Optional[str]:
        acc = trace.acc
        if len(acc) <= self.patience:
            return None
        before = [x for x in acc[:-self.patience] if math.isfinite(x)]
        recent = [x for x in acc[-self.patience:] if math.isfinite(x)]
        if not before or not recent:
            return None
        if max(recent) < max(before) + self.min_delta:
            return (f"acc_plateau: best of last {self.patience} evals "
                    f"{max(recent):.4f} < prior best {max(before):.4f} "
                    f"+ {self.min_delta}")
        return None


@dataclasses.dataclass(frozen=True)
class AnyOf(StopRule):
    """First-match composition: fires with the first member's reason."""

    rules: Tuple[StopRule, ...] = ()
    kind = "any"

    def check(self, trace) -> Optional[str]:
        for rule in self.rules:
            reason = rule.check(trace)
            if reason is not None:
                return reason
        return None

    def to_dict(self) -> Dict:
        return {"kind": self.kind,
                "rules": [r.to_dict() for r in self.rules]}


_RULES = {cls.kind: cls for cls in (MedianLoss, LossSpike, AccPlateau)}


def rule_to_dict(rule: Optional[StopRule]) -> Optional[Dict]:
    return None if rule is None else rule.to_dict()


def rule_from_dict(d: Optional[Dict]) -> Optional[StopRule]:
    if d is None:
        return None
    d = dict(d)
    kind = d.pop("kind")
    if kind == "any":
        return AnyOf(tuple(rule_from_dict(r) for r in d["rules"]))
    try:
        cls = _RULES[kind]
    except KeyError:
        raise ValueError(f"unknown stop rule kind {kind!r}; "
                         f"have {sorted(_RULES) + ['any']}") from None
    return cls(**d)


def default_rules(*, window: int = 8, median_factor: float = 1.3,
                  spike_factor: float = 3.0, patience: int = 5,
                  min_delta: float = 0.003, warmup: int = 4) -> AnyOf:
    """The standard self-stopping bundle: divergence abort, running-median
    loss watch, accuracy-plateau patience."""
    return AnyOf((LossSpike(factor=spike_factor),
                  MedianLoss(window=window, factor=median_factor,
                             warmup=warmup),
                  AccPlateau(patience=patience, min_delta=min_delta)))
