"""REMOVED — the legacy simulator classes, as in
``src/repro/fl/simulator.py``.

The three legacy simulator classes are gone.  Importing them raises
``ImportError`` with the exact :mod:`repro_torch.fl.api` spelling to
migrate to:

    AsyncSimulator(clients, loss_fn, init_params, pcfg, delays)
        -> FLRun(clients=..., loss_fn=..., init_params=..., pcfg=...,
                 delays=..., strategy="persafl", schedule=immediate())

    BufferedAsyncSimulator(..., buffer_size=M)
        -> FLRun(..., schedule=buffered(M))

    SyncSimulator(..., algo="fedavg"|"perfedavg"|"pfedme"|"fedprox"|
                  "scaffold", clients_per_round=m, fedprox_mu=mu)
        -> FLRun(..., strategy=algo, schedule=sync_barrier(m))
           (fedprox_mu=mu  ->  strategy=strategy("fedprox", mu=mu))

``run(max_server_rounds=N)`` is ``run(max_rounds=N)`` (the alias is still
accepted); History, eval hooks and the stats surface carry over unchanged.
"""
from __future__ import annotations

_REMOVED = {
    "AsyncSimulator":
        "FLRun(..., strategy='persafl', schedule=immediate())",
    "BufferedAsyncSimulator":
        "FLRun(..., schedule=buffered(M))",
    "SyncSimulator":
        "FLRun(..., strategy=<algo name>, schedule=sync_barrier(m))",
}


def __getattr__(name: str):
    if name in _REMOVED:
        raise ImportError(
            f"repro_torch.fl.simulator.{name} was removed; use "
            f"{_REMOVED[name]} from repro_torch.fl.api — the "
            f"repro_torch.fl.simulator module docstring has the full "
            f"migration map.")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
