"""Port of the FedProx and SCAFFOLD baselines (``repro_torch.fl.algorithms``,
the ``fedprox``/``scaffold`` strategies of ``repro_torch.fl.api`` and the
stateful half of ``repro_torch.fl.engine``) against ``repro.fl`` on the same
numpy inputs.

The setup is ``tests/test_api.py``'s: a linear softmax model over 5
features, 6 clients of 64 points, batch 8, Q = 2.  Floats: rtol 1e-6 /
atol 1e-7 on params, deltas, control variates and metrics (f32 matrix
products of width 5 summed in other orders than XLA's; the runs here differ
by a few ulps).  The paper CNN's SCAFFOLD update
(``test_updates_match_reference``'s ``cnn`` case) takes atol 1e-6 instead,
as ``tests/test_torch_flrun.py`` does, since its convolutions sum 25-800
products in other orders.  The
event timeline, the server's counters and the engine's stats are numpy and
integers, so they must be equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import MNIST_CNN as J_MNIST
from repro.core import PersAFLConfig as JConfig
from repro.data.federated import ClientData as JClientData
from repro.fl import DelayModel as JDelayModel
from repro.fl import FLRun as JFLRun
from repro.fl import buffered as j_buffered
from repro.fl import immediate as j_immediate
from repro.fl import strategy as j_strategy
from repro.fl import sync_barrier as j_sync_barrier
from repro.fl.algorithms import fedprox_update as j_fedprox_update
from repro.fl.algorithms import scaffold_update as j_scaffold_update
from repro.models import cnn as jcnn
from repro_torch.configs.paper_models import MNIST_CNN
from repro_torch.convert import params_from_jax
from repro_torch.core import PersAFLConfig
from repro_torch.data.federated import ClientData
from repro_torch.fl import (CohortEngine, DelayModel, FLRun, buffered,
                            immediate, strategy, strategy_names,
                            sync_barrier)
from repro_torch.fl.algorithms import fedprox_update, scaffold_update
from repro_torch.models import cnn as tcnn
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-6, atol=1e-7)
CNN_TOL = dict(rtol=0, atol=1e-6)
PCFG = dict(option="A", q_local=2, eta=0.05, alpha=0.05, lam=20.0,
            inner_steps=3, inner_eta=0.02)
SCHEDULES = {"sync3": (j_sync_barrier, sync_barrier, 3),
             "buffered3": (j_buffered, buffered, 3),
             "immediate": (j_immediate, immediate, None)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the shapes are small: one intra-op thread runs them faster and leaves
    # the cores to the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_loss(p, b):
    logits = b["images"] @ p["w"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.sum(jax.nn.one_hot(b["labels"], 4) * logp, -1))


def _loss(p, b):
    logp = torch.log_softmax(b["images"] @ p["w"], -1)
    return -torch.mean(torch.gather(logp, -1, b["labels"].long()[..., None]))


def _clients(cls, n=6, d=5, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(64, d).astype(np.float32)
        y = rng.randint(0, 4, 64).astype(np.int32)
        out.append(cls(train_x=x, train_y=y, test_x=x[:8], test_y=y[:8],
                       classes=(0, 1, 2, 3)))
    return out


def _params(d=5):
    return {"w": np.zeros((d, 4), np.float32)}


def _assert_close(got, want, tol=TOL):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().cpu().numpy(), np.asarray(b),
                                   **tol)


def _spec(name, mu):
    return dict(mu=mu) if name == "fedprox" else {}


@functools.lru_cache(maxsize=None)
def _reference(name, sched, rounds, mu=0.1, n=6):
    j_sched, _, m = SCHEDULES[sched]
    clients = _clients(JClientData, n=n)
    run = JFLRun(clients=clients, loss_fn=_j_loss, init_params=_params(),
                 pcfg=JConfig(**PCFG), delays=JDelayModel(n, seed=1),
                 strategy=j_strategy(name, **_spec(name, mu)),
                 schedule=j_sched() if m is None else j_sched(m),
                 batch_size=8, seed=0)
    hist = run.run(max_rounds=rounds)
    return run, hist


def _port(name, sched, rounds, mu=0.1, n=6, **kw):
    _, t_sched, m = SCHEDULES[sched]
    run = FLRun(clients=_clients(ClientData, n=n), loss_fn=_loss,
                init_params=_params(), pcfg=PersAFLConfig(**PCFG),
                delays=DelayModel(n, seed=1),
                strategy=strategy(name, **_spec(name, mu)),
                schedule=t_sched() if m is None else t_sched(m),
                batch_size=8, seed=0, device="cpu", **kw)
    hist = run.run(max_rounds=rounds)
    return run, hist


def _cnn_setup():
    rng = np.random.RandomState(7)
    params = jax.tree.map(np.asarray, jax.jit(
        jcnn.init_cnn, static_argnums=0)(J_MNIST, jax.random.PRNGKey(0)))
    batches = {"images": rng.rand(2, 8, 28, 28, 1).astype(np.float32),
               "labels": rng.randint(0, 10, (2, 8)).astype(np.int32)}
    return (params, batches,
            lambda p, b: jcnn.cnn_loss(J_MNIST, p, b, train=False),
            lambda p, b: tcnn.cnn_loss(MNIST_CNN, p, b, train=False))


def _linear_setup():
    rng = np.random.RandomState(7)
    params = {"w": (0.3 * rng.randn(5, 4)).astype(np.float32)}
    batches = {"images": rng.randn(2, 8, 5).astype(np.float32),
               "labels": rng.randint(0, 4, (2, 8)).astype(np.int32)}
    return params, batches, _j_loss, _loss


@pytest.mark.parametrize("algo,model", [
    ("fedprox", "linear"), ("scaffold", "linear"), ("scaffold", "cnn")])
def test_updates_match_reference(algo, model):
    """One client's update, the same converted params and numpy batches
    (Q = 2): delta, SCAFFOLD's c_i⁺ and the metrics."""
    params, batches, j_loss, t_loss = (_linear_setup if model == "linear"
                                       else _cnn_setup)()
    tol = TOL if model == "linear" else CNN_TOL
    jcfg, tcfg = JConfig(**PCFG), PersAFLConfig(**PCFG)
    tp = params_from_jax(params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    if algo == "fedprox":
        want, wm = j_fedprox_update(jcfg, j_loss, params, batches, mu=0.3)
        got, gm = fedprox_update(tcfg, t_loss, tp, tb, mu=0.3)
    else:
        rng = np.random.RandomState(11)
        c = jax.tree.map(lambda p: 0.1 * rng.randn(*p.shape).astype(
            np.float32), params)
        ci = jax.tree.map(lambda p: 0.1 * rng.randn(*p.shape).astype(
            np.float32), params)
        want, wc, wm = j_scaffold_update(jcfg, j_loss, params, batches, c, ci)
        got, gc, gm = scaffold_update(tcfg, t_loss, tp, tb,
                                      params_from_jax(c, "cpu"),
                                      params_from_jax(ci, "cpu"))
        _assert_close(gc, wc, tol)
        assert all(x.dtype == torch.float32 for x in tree_leaves(gc))
    assert all(x.dtype == torch.float32 for x in tree_leaves(got))
    _assert_close(got, want, tol)
    assert set(gm) == set(wm) == {"grad_norm_mean", "delta_norm"}
    for key in gm:
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   rtol=1e-6)


@pytest.mark.parametrize("name,sched,rounds", [
    ("fedprox", "sync3", 4), ("scaffold", "sync3", 4),
    ("scaffold", "buffered3", 6), ("fedprox", "buffered3", 6),
    ("scaffold", "immediate", 6)])
def test_flrun_matches_reference(name, sched, rounds):
    """``FLRun`` against the reference's on the same clients, delays and
    seed: timeline, counters, params and SCAFFOLD's c_global."""
    jrun, jhist = _reference(name, sched, rounds)
    run, hist = _port(name, sched, rounds)
    for field in ("times", "rounds", "staleness", "active_times",
                  "active_ratio", "end_time"):
        assert getattr(hist, field) == getattr(jhist, field), field
    _assert_close(run.params, jrun.params)
    if name == "scaffold":
        _assert_close(run.strategy.c_global, jrun.strategy.c_global)
        for got, want in zip(run._cstates, jrun._cstates):
            assert (got is None) == (want is None)
            if got is not None:
                _assert_close(got, want)
    for key in ("cohort_calls", "clients", "max_cohort", "padding_waste",
                "host_materializations", "windows", "cohort_fill_sum"):
        assert run.stats[key] == jrun.stats[key], key
    for key, want in jrun.final_stats.items():
        np.testing.assert_allclose(run.final_stats[key], np.asarray(want),
                                   rtol=1e-6)
    if sched == "sync3":
        assert run.stats["cohort_calls"] == rounds
    if sched != "immediate":
        # deltas landed in the bank and never crossed to the host
        assert run.stats["host_materializations"] == 0


def test_scaffold_client_state_rides_cohort_stack():
    """Client states stack over the cohort axis and the bank hands the
    updated per-client states back, gathered on the device."""
    run, _ = _port("scaffold", "sync3", 2, n=4)
    assert run.engine.stateful
    for cs in run._cstates:
        if cs is None:        # a client the two rounds never sampled
            continue
        assert tree_map(lambda x: tuple(x.shape), cs) == {"w": (5, 4)}
        assert cs["w"].dtype == torch.float32
    # the control variates moved off zero
    assert sum(float(cs["w"].abs().sum()) for cs in run._cstates
               if cs is not None) > 0
    assert run.stats["host_materializations"] == 0


def test_fedprox_mu_zero_matches_fedavg():
    """μ = 0 FedProx is plain local SGD: it must coincide with the fedavg
    strategy through the same engine path."""
    r1, _ = _port("fedprox", "sync3", 2, mu=0.0)
    r2, _ = _port("fedavg", "sync3", 2)
    _assert_close(r1.params, jax.tree.map(
        lambda x: x.numpy(), r2.params))


@pytest.mark.parametrize("name", ["fedprox", "scaffold"])
@pytest.mark.parametrize("impl", ["map", "per-event"])
def test_cohort_impls_match_vmap(name, impl):
    """The ``map`` cohort and the per-event path (``vectorized=False``)
    give the ``vmap`` cohort's params and control variates."""
    kw = dict(vectorized=False) if impl == "per-event" \
        else dict(cohort_impl="map")
    want, _ = _port(name, "buffered3", 6, cohort_impl="vmap")
    got, _ = _port(name, "buffered3", 6, **kw)
    as_np = functools.partial(tree_map, lambda x: x.numpy())
    _assert_close(got.params, as_np(want.params))
    if name == "scaffold":
        _assert_close(got.strategy.c_global, as_np(want.strategy.c_global))
    assert got.stats["host_materializations"] == 0


def test_engine_checks_cstate_list_against_the_strategy():
    scaffold = strategy("scaffold").bind(PersAFLConfig(**PCFG), _loss)
    batches = [{"images": np.zeros((6, 8, 5), np.float32),
                "labels": np.zeros((6, 8), np.int32)}]
    eng = CohortEngine(scaffold.pcfg, _loss, strategy=scaffold,
                       device="cpu")
    with pytest.raises(ValueError, match="cstate_list"):
        eng.update_cohort({"w": torch.zeros(5, 4)}, batches)
    prox = strategy("fedprox").bind(PersAFLConfig(**PCFG), _loss)
    eng = CohortEngine(prox.pcfg, _loss, strategy=prox, device="cpu")
    with pytest.raises(ValueError, match="cstate_list"):
        eng.update_cohort({"w": torch.zeros(5, 4)}, batches,
                          cstate_list=[None])
    assert {"fedprox", "scaffold"} <= set(strategy_names())
    assert strategy("fedprox", mu=0.3).mu == 0.3
    assert strategy("scaffold").stateful and not prox.stateful
