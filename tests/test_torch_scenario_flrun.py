"""Port of ``FLRun``'s scheduler and corruption paths against the JAX
package's on the same inputs: ``scheduler="device"`` (the replayed
:class:`repro_torch.fl.scenario.EventStream`) bit-equal to the heap in the
port, the port's ``FLRun`` against the JAX ``FLRun`` under churn with
adversaries, and ``"auto"``'s choice.

``History``, the run counters and the window log must be equal; params
bit-equal between the port's two schedulers, and within 1e-6 absolute of
the JAX ``FLRun``'s, as ``tests/test_torch_flrun.py`` holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PersAFLConfig as JConfig
from repro.data.federated import ClientData as JClientData
from repro.fl import FLRun as JFLRun
from repro.fl import buffered as j_buffered
from repro.fl import immediate as j_immediate
from repro.fl import scenario as jsc
from repro_torch.core import PersAFLConfig
from repro_torch.data.federated import ClientData
from repro_torch.fl import (Adversarial, DelayModel, FLRun, ScenarioSpec,
                            buffered, immediate, sync_barrier)
from repro_torch.fl import scenario as tsc
from repro_torch.tree import tree_leaves

PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the shapes are small: one intra-op thread runs them faster and leaves
    # the cores to the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_kw(n, seed=3, diurnal=True, dropout=0.15, adversarial=None):
    """A churn spec for either package, made by ``build(mod)`` with
    ``mod`` ``repro.fl.scenario`` or ``repro_torch.fl.scenario``."""
    def build(mod):
        return mod.ScenarioSpec(
            n_clients=n, seed=seed,
            tiers=(mod.Tier("fast", 0.5, 0.7), mod.Tier("slow", 0.5, 1.6)),
            diurnal=mod.Diurnal(period=40.0, floor=0.3) if diurnal
            else None,
            dropout=dropout,
            adversarial=None if adversarial is None
            else mod.Adversarial(*adversarial))
    return build


def _both(build):
    return build(jsc), build(tsc)


def _j_loss(p, b):
    logp = jax.nn.log_softmax(b["images"] @ p["w"])
    return -jnp.mean(jnp.sum(jax.nn.one_hot(b["labels"], 4) * logp, -1))


def _loss(p, b):
    logp = torch.log_softmax(b["images"] @ p["w"], -1)
    return -torch.mean(torch.gather(logp, -1, b["labels"].long()[..., None]))


def _clients(cls, n, d=5, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(64, d).astype(np.float32)
        y = rng.randint(0, 4, 64).astype(np.int32)
        out.append(cls(train_x=x, train_y=y, test_x=x[:8], test_y=y[:8],
                       classes=(0, 1, 2, 3)))
    return out


PCFG = dict(option="A", q_local=2, eta=0.05, alpha=0.05, lam=20.0,
            inner_steps=3, inner_eta=0.02)


def _flrun(n, schedule, scheduler, delays, rounds=10, **kw):
    run = FLRun(clients=_clients(ClientData, n), loss_fn=_loss,
                init_params={"w": np.zeros((5, 4), np.float32)},
                pcfg=PersAFLConfig(**PCFG), delays=delays,
                strategy="persafl", schedule=schedule, batch_size=8, seed=0,
                scheduler=scheduler, device="cpu", **kw)
    return run, run.run(max_rounds=rounds)


def _equal_params(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [16, 100])
@pytest.mark.parametrize("make_schedule,make_delays", [
    (immediate, lambda n: DelayModel(n, seed=1)),
    (lambda: buffered(4), lambda n: DelayModel(n, seed=1)),
    (immediate, lambda n: _spec_kw(n)(tsc).build()),
    (lambda: buffered(4), lambda n: _spec_kw(n)(tsc).build()),
])
def test_flrun_heap_vs_device_bit_equal(n, make_schedule, make_delays):
    """``scheduler="device"`` replays the heap's exact simulation: the same
    History and the same params, bit for bit."""
    rh, hh = _flrun(n, make_schedule(), "heap", make_delays(n))
    rd, hd = _flrun(n, make_schedule(), "device", make_delays(n))
    assert hh.as_dict() == hd.as_dict()
    _equal_params(rh.params, rd.params)
    assert rh.stats["scheduler"] == "heap"
    assert rd.stats["scheduler"] == "device"
    for key in ("dropouts", "windows", "cohort_fill_sum"):
        assert rh.stats[key] == rd.stats[key], key


def test_flrun_per_event_bank_corruption_matches_stacked():
    """The per-event (``vectorized=False``) bank corrupts each row tree by
    its factor, as the stacked bank's ``scale_rows`` does."""
    spec = ScenarioSpec(n_clients=16, seed=2, adversarial=Adversarial(
        0.3, ("scale", "sign_flip"), 5.0))
    rv, hv = _flrun(16, buffered(4), "heap", spec.build())
    re, he = _flrun(16, buffered(4), "heap", spec.build(), vectorized=False)
    assert hv.as_dict() == he.as_dict()
    assert rv.stats["corrupted_rows"] == re.stats["corrupted_rows"] > 0
    for x, y in zip(tree_leaves(rv.params), tree_leaves(re.params)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=PARAM_ATOL,
                                   rtol=0)


# the plain buffered flush's corruption is held by the per-event and NaN
# tests below; against the reference, the per-upload path and the clip
CHURN_SCHEDULES = {
    "immediate": (j_immediate, immediate),
    "buffered4_clip": (lambda: j_buffered(4, robust="clip"),
                       lambda: buffered(4, robust="clip")),
}


@pytest.mark.parametrize("name", sorted(CHURN_SCHEDULES))
def test_flrun_churn_matches_reference(name):
    """Under churn with dropout and scale / sign-flip adversaries, the port
    gives the JAX FLRun's History and counters, and its params within
    PARAM_ATOL."""
    j_sched, t_sched = CHURN_SCHEDULES[name]
    jspec, tspec = _both(_spec_kw(20, adversarial=(
        0.2, ("scale", "sign_flip"), 5.0)))
    jrun = JFLRun(clients=_clients(JClientData, 20), loss_fn=_j_loss,
                  init_params={"w": np.zeros((5, 4), np.float32)},
                  pcfg=JConfig(**PCFG), delays=jspec.build(),
                  strategy="persafl", schedule=j_sched(), batch_size=8,
                  seed=0)
    jhist = jrun.run(max_rounds=16)
    run, hist = _flrun(20, t_sched(), "device", tspec.build(), rounds=16)
    assert hist.as_dict() == jhist.as_dict()
    for a, b in zip(jax.tree.leaves(jrun.params), tree_leaves(run.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=PARAM_ATOL, rtol=0)
    for key in ("corrupted_rows", "robust_clipped", "robust_trimmed",
                "robust_nonfinite", "dropouts", "windows",
                "cohort_fill_sum", "cohort_calls", "padding_waste"):
        assert run.stats[key] == jrun.stats[key], key
    assert run.stats["corrupted_rows"] > 0
    assert (run.stats["robust_clipped"] > 0) == name.endswith("clip")
    assert run.window_log == jrun.window_log


def test_nan_adversaries_poison_plain_but_not_robust():
    """25% NaN-bombing clients destroy the plain buffered flush; clip and
    trim admissions keep the params finite."""
    spec = ScenarioSpec(n_clients=16, seed=5,
                        adversarial=Adversarial(frac=0.25, kinds=("nan",)))

    def go(schedule):
        run, _ = _flrun(16, schedule, "heap", spec.build(), rounds=24)
        return run, all(bool(torch.isfinite(x).all())
                        for x in tree_leaves(run.params))

    r0, f0 = go(buffered(4))
    r1, f1 = go(buffered(4, robust="clip"))
    r2, f2 = go(buffered(4, robust="trim", trim_frac=0.3))
    assert r0.stats["corrupted_rows"] > 0
    assert not f0
    assert f1 and f2
    assert r1.stats["robust_nonfinite"] > 0
    assert r2.stats["robust_nonfinite"] > 0


def test_auto_resolves_to_device_at_4096_clients():
    """``"auto"`` takes the stream from 4096 clients up (the heap's run,
    as the cases above show at 16 and 100); ``sync_barrier`` ignores the
    flag."""
    # thousands of downloads precede the first upload: one vmapped cohort
    run, hist = _flrun(4096, immediate(), "auto", DelayModel(4096, seed=1),
                       rounds=1, cohort_impl="vmap")
    assert run.stats["scheduler"] == "device"
    assert len(hist.staleness) == 1 and run.stats["clients"] > 1000
    small, _ = _flrun(16, buffered(4), "auto", DelayModel(16, seed=1),
                      rounds=4)
    assert small.stats["scheduler"] == "heap"
    rh, hh = _flrun(16, sync_barrier(4), "heap", DelayModel(16, seed=1),
                    rounds=3)
    rd, hd = _flrun(16, sync_barrier(4), "device", DelayModel(16, seed=1),
                    rounds=3)
    assert hh.as_dict() == hd.as_dict()
    _equal_params(rh.params, rd.params)


def test_flrun_stats_surface_and_scheduler_arg():
    run, _ = _flrun(16, buffered(4), "auto", _spec_kw(16)(tsc).build())
    s = run.stats
    for key in ("scheduler", "windows", "cohort_fill_sum", "cohort_fill_max",
                "mean_cohort_fill", "dropouts", "corrupted_rows",
                "robust_clipped", "robust_trimmed", "robust_nonfinite",
                "cohort_calls", "host_materializations"):
        assert key in s, key
    assert s["mean_cohort_fill"] == pytest.approx(4.0)
    assert run.window_log and run.window_log[0]["window"] == 1
    assert "corrupted_rows" in run.window_log[0]
    with pytest.raises(ValueError):
        _flrun(2, immediate(), "gpu", DelayModel(2))

