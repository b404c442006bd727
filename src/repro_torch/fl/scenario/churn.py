"""Trace-driven churn: the :class:`ChurnModel` delay/behavior model, a numpy
copy of ``src/repro/fl/scenario/churn.py`` with bit-identical fields.

Extends :class:`repro_torch.fl.DelayModel` with the traffic shapes the paper's
staleness claim actually meets at scale — all derived from the same pure
counter-based hash streams (:func:`repro_torch.fl.delays.hash_u01`), so the
per-event heap, the vectorized host :class:`EventStream` and the
device-resident :class:`DeviceScheduler` all see identical behavior:

  * **speed tiers** — each client is hash-assigned a device-class tier
    (:class:`repro_torch.fl.scenario.Tier`); its delays scale by the tier's
    ``speed`` multiplier;
  * **diurnal availability** — a per-client-phased sinusoid
    (:class:`repro_torch.fl.scenario.Diurnal`); delays divide by availability,
    so a client deep in its night completes rounds slowly instead of
    disappearing (availability never hits zero: ``floor`` > 0);
  * **mid-round dropout** — with probability ``dropout`` a cycle's client
    vanishes *after* its download completes but *before* its upload: no
    delta is computed and no upload event fires, but the client stays
    offline for the would-be upload duration before its next download
    (keeps realized timelines identical across scheduler backends);
  * **adversarial clients** — a hash-chosen ``frac`` of clients corrupt
    every delta they upload (scaled / sign-flipped / NaN, per
    :class:`repro_torch.fl.scenario.Adversarial`); the corruption itself is
    applied on-device to bank rows (``repro_torch.core.server.scale_rows``) and
    defended by the robust admission variants
    (``repro_torch.core.robust_admission_weights``).

Build one declaratively: ``ScenarioSpec(...).build()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.fl.delays import (DelayModel, TAG_ADV, TAG_DROP, TAG_PHASE,
                             TAG_TIER, hash_u01)
from repro_torch.fl.scenario.spec import (Adversarial, Diurnal, ScenarioSpec,
                                    Tier)

_TWO_PI = 2.0 * np.pi


@dataclasses.dataclass
class ChurnModel(DelayModel):
    """Trace-driven :class:`DelayModel`: tiers × diurnal × dropout ×
    adversaries.  Same pure/stateful surface as the base class — the
    schedulers need no churn-specific code paths beyond reading
    :meth:`drops_at` and :meth:`corruption_factors`."""

    tiers: Tuple[Tier, ...] = (Tier("uniform", 1.0, 1.0),)
    diurnal: Optional[Diurnal] = None
    dropout: float = 0.0
    adversarial: Optional[Adversarial] = None

    def __post_init__(self):
        super().__post_init__()
        ids = np.arange(self.n_clients)
        frac = np.array([t.frac for t in self.tiers], np.float64)
        cum = np.cumsum(frac / frac.sum())
        u = hash_u01(self.seed, ids, 0, TAG_TIER)
        self.tier_index = np.minimum(
            np.searchsorted(cum, u, side="right"), len(self.tiers) - 1)
        speeds = np.array([t.speed for t in self.tiers], np.float64)
        self.tier_mult = speeds[self.tier_index]
        self.phase = hash_u01(self.seed, ids, 0, TAG_PHASE)
        adv = self.adversarial
        if adv is not None and adv.frac > 0.0:
            mask = hash_u01(self.seed, ids, 0, TAG_ADV) < adv.frac
            kind_idx = np.minimum(
                (hash_u01(self.seed, ids, 1, TAG_ADV)
                 * len(adv.kinds)).astype(np.int64), len(adv.kinds) - 1)
            fac = np.ones(self.n_clients, np.float64)
            for j, kind in enumerate(adv.kinds):
                val = {"scale": adv.magnitude,
                       "sign_flip": -adv.magnitude,
                       "nan": np.nan}[kind]
                fac = np.where(mask & (kind_idx == j), val, fac)
            self._adv_factor = fac.astype(np.float32)
            self.adversary_ids = ids[mask]
        else:
            self._adv_factor = None
            self.adversary_ids = np.empty(0, np.int64)

    @staticmethod
    def from_spec(spec: ScenarioSpec) -> "ChurnModel":
        return spec.build()

    # -- behavior hooks (pure, vectorized; see DelayModel) -----------------

    def availability(self, i, t):
        """Availability ∈ [floor, 1] of client(s) ``i`` at time(s) ``t``
        (1.0 without a diurnal curve); delays divide by it."""
        if self.diurnal is None:
            return 1.0
        d = self.diurnal
        ph = _TWO_PI * (np.asarray(t, np.float64) / d.period
                        + self.phase[i])
        return d.floor + (1.0 - d.floor) * 0.5 * (1.0 + np.sin(ph))

    def _speed(self, i, t):
        return self.tier_mult[i] / self.availability(i, t)

    def drops_at(self, i, k):
        if self.dropout <= 0.0:
            return super().drops_at(i, k)
        return hash_u01(self.seed, i, k, TAG_DROP) < self.dropout

    def corruption_factors(self, ids):
        """Per-client delta corruption factor for ``ids`` (f32; 1.0 for
        honest clients, ±magnitude / NaN for adversaries), or None when
        the scenario has no adversarial population."""
        if self._adv_factor is None:
            return None
        return self._adv_factor[np.asarray(ids, np.int64)]
