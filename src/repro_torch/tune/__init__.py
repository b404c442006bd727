"""`repro_torch.tune` — the self-stopping tuner subsystem, as in
``src/repro/tune``.

Declarative sweeps (:class:`SweepSpec` → fingerprinted :class:`Arm`\\ s,
successive-halving ``hillclimb``), pure early-stop rules evaluated on the
live :class:`repro_torch.fl.History` trace, a resumable journaled arm executor
(:class:`TuneRunner`) driving ``FLRun.run(on_eval=...)``, and the
fig2-style report.  Fingerprints, trial keys, journal rows, stop reasons
and reports equal the reference tuner's on the same sweep.
"""
from repro_torch.tune.space import (Arm, SweepSpec,  # noqa: F401
                                    parse_schedule, promote, rung_arms)
from repro_torch.tune.stop import (AccPlateau, AnyOf,  # noqa: F401
                                   LossSpike, MedianLoss, StopRule,
                                   default_rules, rule_from_dict,
                                   rule_to_dict)
from repro_torch.tune.runner import (Trial, TuneRunner,  # noqa: F401
                                     trial_key)
from repro_torch.tune.report import (make_report,  # noqa: F401
                                     promote_winners, to_markdown)
