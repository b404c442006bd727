"""Federated runs: delays, the cohort engine, evaluation and ``FLRun``."""
from repro_torch.fl.delays import DelayModel  # noqa: F401
from repro_torch.fl.engine import CohortEngine, DeltaBank  # noqa: F401
from repro_torch.fl.api import (ApplyPolicy, FLRun, History,  # noqa: F401
                                Strategy, buffered, immediate,
                                register_strategy, strategy, strategy_names,
                                sync_barrier)
from repro_torch.fl.evaluate import make_personalized_eval  # noqa: F401
