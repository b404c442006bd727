"""Port of ``FLRun`` (``repro_torch.fl.api``) against ``repro.fl.FLRun`` on
the same clients, delays, seed and JAX init, under the three schedules.

The event timeline is numpy and Python in both packages, so ``times``,
``rounds``, ``staleness``, ``active_times``, ``active_ratio``, the server's
counters and the engine's stats must be equal.  Floats: params 1e-6
absolute (12 server rounds, each folding Q local steps of f32 convolutions
summed in other orders than XLA's; the runs here differ by under 1e-7);
accuracy 1/384, one of the 6 × 64 test predictions, which a near-tie in the
logits may flip.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import MNIST_CNN as J_MNIST
from repro.core import PersAFLConfig as JConfig
from repro.data import make_federated_dataset as j_make_dataset
from repro.fl import DelayModel as JDelayModel
from repro.fl import FLRun as JFLRun
from repro.fl import buffered as j_buffered
from repro.fl import immediate as j_immediate
from repro.fl import make_personalized_eval as j_make_eval
from repro.fl import strategy as j_strategy
from repro.fl import sync_barrier as j_sync_barrier
from repro.models import cnn as jcnn
from repro_torch.configs.paper_models import MNIST_CNN
from repro_torch.convert import params_from_jax
from repro_torch.core import PersAFLConfig
from repro_torch.data import make_federated_dataset
from repro_torch.fl import (DelayModel, FLRun, buffered, immediate,
                            make_personalized_eval, strategy,
                            strategy_names, sync_barrier)
from repro_torch.models import cnn as tcnn
from repro_torch.tree import tree_leaves

PARAM_ATOL = 1e-6
ACC_ATOL = 1.0 / 384 + 1e-6
N_CLIENTS, ROUNDS, EVAL_EVERY = 6, 12, 4
PCFG = dict(q_local=2, eta=0.01, lam=25.0, inner_steps=3, inner_eta=0.02)
SCHEDULES = {
    "immediate": ("C", j_immediate, immediate),
    "buffered4": ("C", lambda: j_buffered(4), lambda: buffered(4)),
    "sync3": ("A", lambda: j_sync_barrier(3), lambda: sync_barrier(3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the shapes are small: one intra-op thread runs them faster and leaves
    # the cores to the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference():
    clients = j_make_dataset("mnist", n_clients=N_CLIENTS,
                             classes_per_client=3, seed=0)
    params = jax.jit(jcnn.init_cnn, static_argnums=0)(
        J_MNIST, jax.random.PRNGKey(0))
    loss = lambda p, b: jcnn.cnn_loss(J_MNIST, p, b, train=False)  # noqa
    acc = lambda p, b: jcnn.cnn_accuracy(J_MNIST, p, b)  # noqa: E731
    return clients, params, loss, j_make_eval(loss, acc, clients)


@functools.lru_cache(maxsize=None)
def _run_reference(name):
    option, j_sched, _ = SCHEDULES[name]
    clients, params, loss, ev = _reference()
    run = JFLRun(clients=clients, loss_fn=loss, init_params=params,
                 pcfg=JConfig(option=option, **PCFG),
                 delays=JDelayModel(N_CLIENTS, seed=0),
                 strategy=j_strategy("persafl", option=option),
                 schedule=j_sched(), batch_size=8, seed=0)
    hist = run.run(max_rounds=ROUNDS, eval_every=EVAL_EVERY, eval_fn=ev)
    return (hist, jax.tree.map(np.asarray, run.params),
            {k: np.asarray(v) for k, v in run.final_stats.items()},
            dict(run.stats))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_flrun_matches_reference(name):
    option, _, t_sched = SCHEDULES[name]
    jhist, jparams, jfinal, jstats = _run_reference(name)
    _, params, _, _ = _reference()
    clients = make_federated_dataset("mnist", n_clients=N_CLIENTS,
                                     classes_per_client=3, seed=0)
    loss = lambda p, b: tcnn.cnn_loss(MNIST_CNN, p, b, train=False)  # noqa
    acc = lambda p, b: tcnn.cnn_accuracy(MNIST_CNN, p, b)  # noqa: E731
    run = FLRun(clients=clients, loss_fn=loss,
                init_params=jax.tree.map(np.asarray, params),
                pcfg=PersAFLConfig(option=option, **PCFG),
                delays=DelayModel(N_CLIENTS, seed=0),
                strategy=strategy("persafl", option=option),
                schedule=t_sched(), batch_size=8, seed=0, device="cpu")
    hist = run.run(max_rounds=ROUNDS, eval_every=EVAL_EVERY,
                   eval_fn=make_personalized_eval(loss, acc, clients))
    for field in ("times", "rounds", "staleness", "active_times",
                  "active_ratio", "end_time"):
        assert getattr(hist, field) == getattr(jhist, field), field
    assert len(hist.acc) == len(jhist.acc) > 0
    np.testing.assert_allclose(hist.acc, jhist.acc, atol=ACC_ATOL, rtol=0)
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(run.params)):
        np.testing.assert_allclose(b.numpy(), a, atol=PARAM_ATOL, rtol=0)
    assert run.final_stats.keys() == jfinal.keys()
    for key, want in jfinal.items():
        np.testing.assert_allclose(run.final_stats[key], want, rtol=1e-6)
    for key in ("cohort_calls", "clients", "max_cohort", "padding_waste",
                "host_materializations", "windows", "cohort_fill_sum",
                "cohort_fill_max"):
        assert run.stats[key] == jstats[key], key


def test_flrun_raises_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clients = make_federated_dataset("mnist", n_clients=2,
                                     classes_per_client=2, seed=0)
    kw = dict(clients=clients, loss_fn=lambda p, b: 0.0,
              init_params=params_from_jax(
                  jax.tree.map(np.asarray, _reference()[1]), "cpu"),
              pcfg=PersAFLConfig(), delays=DelayModel(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLRun(**kw)
    assert FLRun(device="cpu", **kw).device.type == "cpu"


@pytest.mark.parametrize("kw,err", [
    (dict(strategy="nope"), ValueError),
    (dict(schedule="bogus"), ValueError),
    (dict(scheduler="gpu"), ValueError),
])
def test_flrun_refuses_what_is_not_ported(kw, err):
    clients = make_federated_dataset("mnist", n_clients=2,
                                     classes_per_client=2, seed=0)
    with pytest.raises(err):
        FLRun(clients=clients, loss_fn=lambda p, b: 0.0,
              init_params={"w": np.zeros(3, np.float32)},
              pcfg=PersAFLConfig(), delays=DelayModel(2), device="cpu", **kw)
    with pytest.raises(ValueError, match="robust"):
        buffered(4, robust="median")
    assert {"persafl", "fedasync", "perfedavg", "pfedme", "fedprox",
            "scaffold"} <= set(strategy_names())


def test_run_budget_stop_and_final_eval():
    """``max_time`` clamps the clock, an ``on_eval`` "stop" halts after the
    current apply, ``final_eval`` scores the stop time, and an eval_fn with
    ``with_loss`` fills ``History.loss`` beside ``acc``."""
    clients = make_federated_dataset("mnist", n_clients=4,
                                     classes_per_client=2, seed=1)
    params = params_from_jax(jax.tree.map(np.asarray, _reference()[1]),
                             "cpu")
    loss = lambda p, b: tcnn.cnn_loss(MNIST_CNN, p, b, train=False)  # noqa
    acc = lambda p, b: tcnn.cnn_accuracy(MNIST_CNN, p, b)  # noqa: E731
    ev = make_personalized_eval(loss, acc, clients, with_loss=True)

    def make():
        return FLRun(clients=clients, loss_fn=loss, init_params=params,
                     pcfg=PersAFLConfig(option="A", q_local=1),
                     delays=DelayModel(4), batch_size=4, device="cpu")

    hist = make().run(max_rounds=50, max_time=20.0, eval_fn=ev,
                      eval_every=100, final_eval=True)
    assert hist.end_time == 20.0 and hist.times == [20.0]
    assert hist.as_dict()["end_time"] == 20.0
    assert len(hist.acc) == len(hist.loss) == 1
    hist = make().run(max_rounds=50, eval_every=2, eval_fn=ev,
                      on_eval=lambda h: "stop")
    assert hist.rounds == [2] and len(hist.staleness) == 2
    with pytest.raises(ValueError, match="matches no param leaf"):
        make_personalized_eval(loss, acc, clients,
                               personal_subset=("head",))(params)


@pytest.mark.parametrize("robust", ["clip", "trim"])
def test_buffered_robust_matches_reference(robust):
    """``buffered(4, robust=...)``: the flush weights come from
    ``robust_flush_weights`` over the whole buffer; params and the robust
    counters must match the reference.  Honest deltas stay under clip's
    2 × median bound, so clip gets an explicit bound below every norm
    (about 0.02 here), far from a tie."""
    kw = dict(clip_norm=1e-3) if robust == "clip" else {}
    _, params, _, _ = _reference()
    jclients, jloss = _reference()[0], _reference()[2]
    run_j = JFLRun(clients=jclients, loss_fn=jloss, init_params=params,
                   pcfg=JConfig(option="A", **PCFG),
                   delays=JDelayModel(N_CLIENTS, seed=0),
                   schedule=j_buffered(4, robust=robust, **kw), batch_size=8,
                   seed=0)
    run_j.run(max_rounds=ROUNDS)
    clients = make_federated_dataset("mnist", n_clients=N_CLIENTS,
                                     classes_per_client=3, seed=0)
    loss = lambda p, b: tcnn.cnn_loss(MNIST_CNN, p, b, train=False)  # noqa
    run = FLRun(clients=clients, loss_fn=loss,
                init_params=jax.tree.map(np.asarray, params),
                pcfg=PersAFLConfig(option="A", **PCFG),
                delays=DelayModel(N_CLIENTS, seed=0),
                schedule=buffered(4, robust=robust, **kw), batch_size=8,
                seed=0,
                device="cpu")
    run.run(max_rounds=ROUNDS)
    for a, b in zip(jax.tree.leaves(run_j.params), tree_leaves(run.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=PARAM_ATOL,
                                   rtol=0)
    for key in ("windows", "robust_clipped", "robust_trimmed",
                "robust_nonfinite"):
        assert run.stats[key] == run_j.stats[key], key
    assert run.stats["robust_" + ("clipped" if robust == "clip"
                                  else "trimmed")] > 0


def test_personal_subset_eval_matches_reference():
    """``make_personalized_eval(personal_subset=...)`` fine-tunes only the
    subset; the score must match the reference's, and differ from the
    full fine-tune's."""
    clients, params, jloss, _ = _reference()
    jacc = lambda p, b: jcnn.cnn_accuracy(J_MNIST, p, b)  # noqa: E731
    tclients = make_federated_dataset("mnist", n_clients=N_CLIENTS,
                                      classes_per_client=3, seed=0)
    loss = lambda p, b: tcnn.cnn_loss(MNIST_CNN, p, b, train=False)  # noqa
    acc = lambda p, b: tcnn.cnn_accuracy(MNIST_CNN, p, b)  # noqa: E731
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    kw = dict(ft_steps=2, ft_lr=0.5, with_loss=True)
    for subset in ("fc/#1", ("conv/#0", "fc/#1/b")):
        want = j_make_eval(jloss, jacc, clients, personal_subset=subset,
                           **kw)(params)
        got = make_personalized_eval(loss, acc, tclients,
                                     personal_subset=subset, **kw)(tparams)
        assert abs(got["acc"] - want["acc"]) <= ACC_ATOL
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    full = make_personalized_eval(loss, acc, tclients, **kw)(tparams)
    assert full["loss"] != got["loss"]


def _drift(rounds: int = 75, every: int = 15) -> None:
    """Run (a) of ``chip_smoke.py`` (fig2 MNIST, 30 clients, Option C,
    immediate) in the reference and in the port on the CPU, from the same
    JAX init, and print the max param difference after every apply and the
    accuracy every ``every`` rounds; the port's ``vmap`` cohort against its
    ``map`` cohort gives the same math summed in another order."""
    import time
    fig2 = dict(q_local=10, beta=1.0, alpha=0.01, lam=25.0, inner_steps=10,
                inner_eta=0.02, maml_mode="full", eta=0.002)
    params = jax.tree.map(np.asarray, jax.jit(
        jcnn.init_cnn, static_argnums=0)(J_MNIST, jax.random.PRNGKey(0)))
    jclients = j_make_dataset("mnist", n_clients=30, classes_per_client=5,
                              seed=0)
    tclients = make_federated_dataset("mnist", n_clients=30,
                                      classes_per_client=5, seed=0)

    def recorder(ev, flat):
        snaps, accs = [], []

        def rec(p):
            snaps.append(flat(p))
            if len(snaps) % every == 0:
                accs.append(round(float(ev(p)), 4))
            return 0.0
        return rec, snaps, accs

    out = {}
    jloss = lambda p, b: jcnn.cnn_loss(J_MNIST, p, b, train=False)  # noqa
    jacc = lambda p, b: jcnn.cnn_accuracy(J_MNIST, p, b)  # noqa: E731
    rec, snaps, accs = recorder(
        j_make_eval(jloss, jacc, jclients),
        lambda p: np.concatenate([np.ravel(x) for x in jax.tree.leaves(p)]))
    t0 = time.time()
    JFLRun(clients=jclients, loss_fn=jloss, init_params=params,
           pcfg=JConfig(option="C", **fig2), delays=JDelayModel(30),
           strategy=j_strategy("persafl", option="C"),
           schedule=j_immediate(), batch_size=16, seed=0).run(
        max_rounds=rounds, eval_every=1, eval_fn=rec)
    out["jax"] = (np.stack(snaps), accs, time.time() - t0)
    tloss = lambda p, b: tcnn.cnn_loss(MNIST_CNN, p, b, train=False)  # noqa
    tacc = lambda p, b: tcnn.cnn_accuracy(MNIST_CNN, p, b)  # noqa: E731
    for impl in ("map", "vmap"):
        rec, snaps, accs = recorder(
            make_personalized_eval(tloss, tacc, tclients),
            lambda p: np.concatenate([x.numpy().ravel()
                                      for x in tree_leaves(p)]))
        t0 = time.time()
        FLRun(clients=tclients, loss_fn=tloss, init_params=params,
              pcfg=PersAFLConfig(option="C", **fig2), delays=DelayModel(30),
              strategy=strategy("persafl", option="C"), schedule=immediate(),
              batch_size=16, seed=0, device="cpu", cohort_impl=impl).run(
            max_rounds=rounds, eval_every=1, eval_fn=rec)
        out[impl] = (np.stack(snaps), accs, time.time() - t0)
    for name, (_, accs, wall) in out.items():
        print(f"{name}: wall {wall:.1f} s, acc every {every} rounds {accs}")
    jx, mp, vm = out["jax"][0], out["map"][0], out["vmap"][0]
    print("round, max|jax - port map|, max|port map - port vmap|")
    for r in range(rounds):
        print(r + 1, f"{np.abs(jx[r] - mp[r]).max():.3e}",
              f"{np.abs(mp[r] - vm[r]).max():.3e}")


if __name__ == "__main__":
    # the long comparison PERF.md cites (several minutes on the CPU):
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_flrun.py
    _drift()
