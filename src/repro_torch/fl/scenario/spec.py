"""Declarative scenario specification (JSON-serializable), a copy of
``src/repro/fl/scenario/spec.py``: ``to_json`` gives the reference's string
byte for byte, since tuner fingerprints hash it.

A :class:`ScenarioSpec` is the single declarative knob for trace-driven
client behavior: device-class speed tiers, a diurnal availability curve,
mid-round dropout, and adversarial clients — everything the
:class:`repro_torch.fl.scenario.ChurnModel` needs, as plain data.  Specs
round-trip through JSON (``to_json`` / ``from_json``) so a churn sweep's
exact traffic shape can be committed next to its results and replayed
bit-for-bit (all client behavior is a pure hash of ``(seed, client,
counter, tag)`` — see :mod:`repro_torch.fl.delays`).

Example::

    spec = ScenarioSpec(
        n_clients=100_000, seed=0,
        tiers=(Tier("flagship", frac=0.2, speed=0.5),
               Tier("mid", frac=0.5, speed=1.0),
               Tier("budget", frac=0.3, speed=2.5)),
        diurnal=Diurnal(period=86_400.0, floor=0.25),
        dropout=0.05,
        adversarial=Adversarial(frac=0.05, kinds=("scale", "sign_flip"),
                                magnitude=50.0))
    model = spec.build()                       # -> ChurnModel
    open("spec.json", "w").write(spec.to_json())
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

ADVERSARY_KINDS = ("scale", "sign_flip", "nan")


@dataclasses.dataclass(frozen=True)
class Tier:
    """One device-class speed tier: ``frac`` of the population (fractions
    are normalized over the tier list) runs at ``speed``× the nominal
    delay (2.0 = twice as slow, 0.5 = twice as fast)."""
    name: str
    frac: float
    speed: float


@dataclasses.dataclass(frozen=True)
class Diurnal:
    """Sinusoidal availability curve with per-client phase: availability
    at time t is ``floor + (1-floor) * 0.5 * (1 + sin(2π(t/period +
    phase_i)))`` ∈ [floor, 1]; realized delays divide by it (an offline-ish
    client's round stretches instead of vanishing)."""
    period: float = 86_400.0
    floor: float = 0.25


@dataclasses.dataclass(frozen=True)
class Adversarial:
    """Adversarial population: ``frac`` of clients corrupt every delta
    they upload.  Each adversary is hash-assigned one kind from ``kinds``:
    ``"scale"`` multiplies the delta by ``magnitude``, ``"sign_flip"`` by
    ``-magnitude``, ``"nan"`` poisons it with NaNs."""
    frac: float = 0.0
    kinds: Tuple[str, ...] = ("scale", "sign_flip")
    magnitude: float = 50.0


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Full scenario: paper-§5 delay statistics + churn + adversaries."""
    n_clients: int
    seed: int = 0
    tiers: Tuple[Tier, ...] = (Tier("uniform", 1.0, 1.0),)
    diurnal: Optional[Diurnal] = None
    dropout: float = 0.0
    adversarial: Optional[Adversarial] = None
    down_range: Tuple[float, float] = (1.0, 3.0)
    up_factor_range: Tuple[float, float] = (4.0, 6.0)
    jitter: Tuple[float, float] = (0.5, 1.5)
    scale: float = 1.0

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError("need at least one client")
        if not self.tiers:
            raise ValueError("need at least one tier")
        if sum(t.frac for t in self.tiers) <= 0:
            raise ValueError("tier fractions must sum to > 0")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), "
                             f"got {self.dropout}")
        if self.diurnal is not None \
                and not 0.0 < self.diurnal.floor <= 1.0:
            raise ValueError(f"diurnal floor must be in (0, 1], "
                             f"got {self.diurnal.floor}")
        if self.adversarial is not None:
            adv = self.adversarial
            if not 0.0 <= adv.frac < 1.0:
                raise ValueError(f"adversarial frac must be in [0, 1), "
                                 f"got {adv.frac}")
            bad = [k for k in adv.kinds if k not in ADVERSARY_KINDS]
            if bad or not adv.kinds:
                raise ValueError(f"adversary kinds must be non-empty, "
                                 f"from {ADVERSARY_KINDS}; got {adv.kinds}")

    # -- JSON round-trip ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "ScenarioSpec":
        d = json.loads(s)
        d["tiers"] = tuple(Tier(**t) for t in d.get("tiers", []))
        if d.get("diurnal") is not None:
            d["diurnal"] = Diurnal(**d["diurnal"])
        if d.get("adversarial") is not None:
            a = dict(d["adversarial"])
            a["kinds"] = tuple(a.get("kinds", ()))
            d["adversarial"] = Adversarial(**a)
        for key in ("down_range", "up_factor_range", "jitter"):
            d[key] = tuple(d[key])
        return ScenarioSpec(**d)

    # -- model construction ------------------------------------------------

    def build(self):
        """-> the :class:`repro_torch.fl.scenario.ChurnModel` this spec
        describes (a drop-in :class:`repro_torch.fl.DelayModel`)."""
        from repro_torch.fl.scenario.churn import ChurnModel
        return ChurnModel(
            n_clients=self.n_clients, seed=self.seed,
            down_range=self.down_range,
            up_factor_range=self.up_factor_range,
            jitter=self.jitter, scale=self.scale,
            tiers=self.tiers, diurnal=self.diurnal,
            dropout=self.dropout, adversarial=self.adversarial)
