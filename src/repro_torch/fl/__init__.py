"""Federated runs: delays, the cohort engine, evaluation, ``FLRun`` and the
scenario engine."""
from repro_torch.fl.delays import DelayModel  # noqa: F401
from repro_torch.fl.engine import CohortEngine, DeltaBank  # noqa: F401
from repro_torch.fl.api import (ApplyPolicy, FLRun, History,  # noqa: F401
                                Strategy, buffered, immediate,
                                register_strategy, strategy, strategy_names,
                                sync_barrier)
from repro_torch.fl.evaluate import make_personalized_eval  # noqa: F401
from repro_torch.fl.scenario import (Adversarial, ChurnModel,  # noqa: F401
                                     DeviceScheduler, Diurnal, EventStream,
                                     ScenarioSpec, Tier)


def __getattr__(name: str):
    # the removed simulator classes: defer to repro_torch.fl.simulator's
    # ImportError breadcrumb (it names the FLRun spelling to migrate to)
    if name in ("AsyncSimulator", "BufferedAsyncSimulator",
                "SyncSimulator"):
        from repro_torch.fl import simulator
        return getattr(simulator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
