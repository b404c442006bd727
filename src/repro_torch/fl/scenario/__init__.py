"""Million-client scenario engine, as in ``src/repro/fl/scenario``:
device-side event scheduling, trace-driven churn, and the declarative
:class:`ScenarioSpec`.

Three layers (see each module's docstring):

  * :mod:`repro_torch.fl.scenario.spec` — :class:`ScenarioSpec` /
    :class:`Tier` / :class:`Diurnal` / :class:`Adversarial`: the
    JSON-round-tripping declarative description of a traffic shape;
  * :mod:`repro_torch.fl.scenario.churn` — :class:`ChurnModel`, the
    trace-driven :class:`repro_torch.fl.DelayModel` (speed tiers, diurnal
    availability, mid-round dropout, adversarial clients) built from a
    spec;
  * :mod:`repro_torch.fl.scenario.sched` — :class:`EventStream` (the
    host-vectorized float64 twin of FLRun's heap, bit-equal event order)
    and :class:`DeviceScheduler` (the cohort former for the
    10^5–10^6-client regime, its state on the card).

Robust admission against the adversarial rows lives in
:mod:`repro_torch.core.server` (``robust_admission_weights`` /
``bank_row_norms`` / ``mask_rows`` / ``scale_rows``) and is consumed by
``buffered(m, robust=...)`` and ``DeltaRing(robust=...)``.
"""
from repro_torch.fl.scenario.spec import (Adversarial,  # noqa: F401
                                          Diurnal, ScenarioSpec, Tier)
from repro_torch.fl.scenario.churn import ChurnModel  # noqa: F401
from repro_torch.fl.scenario.sched import (DeviceScheduler,  # noqa: F401
                                           EventStream, KIND_DOWN, KIND_UP)
