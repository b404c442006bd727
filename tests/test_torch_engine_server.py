"""Port of the server applies, the cohort engine and the numpy pipeline
(``repro_torch.core.server``, ``repro_torch.fl.engine``,
``repro_torch.data.federated``, ``repro_torch.fl.delays``) against the
reference on the same inputs.

Everything numpy or integer must be equal: data arrays, delay draws,
admission weights, the server's counters and the engine's stats.  Floats:
apply_update 1e-6 (one f32 elementwise pass); apply_buffered_rows atol 1e-5
/ rtol 1e-4 (the reductions sum the M rows in different orders); cohort
banks 2e-6 absolute with 1e-4 relative (Q local steps of f32 convolutions
summed in other orders than XLA's).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import MNIST_CNN as J_MNIST
from repro.core import PersAFLConfig as JConfig
from repro.core import admission_weights as j_admission_weights
from repro.core import apply_buffered as j_apply_buffered
from repro.core import apply_buffered_rows as j_apply_buffered_rows
from repro.core import apply_update as j_apply_update
from repro.core import init_server_state as j_init_server_state
from repro.core.server import staleness_stats as j_staleness_stats
from repro.data import federated as jfed
from repro.fl import CohortEngine as JEngine
from repro.fl import delays as jdelays
from repro.models.cnn import cnn_loss as j_cnn_loss
from repro.models.cnn import init_cnn as j_init_cnn
from repro_torch.configs.paper_models import MNIST_CNN
from repro_torch.convert import params_from_jax
from repro_torch.core import (PersAFLConfig, admission_weights,
                              apply_buffered, apply_buffered_rows,
                              apply_update,
                              init_server_state, staleness_stats)
from repro_torch.data import federated as tfed
from repro_torch.fl import CohortEngine
from repro_torch.fl import delays as tdelays
from repro_torch.models.cnn import cnn_loss
from repro_torch.tree import tree_leaves

APPLY_TOL = 1e-6
ROWS_ATOL, ROWS_RTOL = 1e-5, 1e-4
BANK_ATOL, BANK_RTOL = 2e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the shapes are small: one intra-op thread runs them faster and leaves
    # the cores to the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    return jax.tree.map(np.asarray, jax.jit(j_init_cnn, static_argnums=0)(
        J_MNIST, jax.random.PRNGKey(0)))


def _assert_tree_close(got, want, **tol):
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(b.detach().cpu().numpy(), np.asarray(a),
                                   **tol)


# ---------------------------------------------------------------------------
# numpy pipeline: bit-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,cpc", [("mnist", 5), ("cifar", 3)])
def test_federated_data_is_bit_identical(kind, cpc):
    want = jfed.make_federated_dataset(kind, n_clients=5,
                                       classes_per_client=cpc, seed=2)
    got = tfed.make_federated_dataset(kind, n_clients=5,
                                      classes_per_client=cpc, seed=2)
    for a, b in zip(want, got):
        assert a.classes == b.classes
        for f in ("train_x", "train_y", "test_x", "test_y"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
        wb = jfed.sample_batches(a, np.random.RandomState(7), 6, 8)
        gb = tfed.sample_batches(b, np.random.RandomState(7), 6, 8)
        assert all(np.array_equal(wb[k], gb[k]) for k in wb)
        we, ge = jfed.eval_batch(a, 64, seed=1), tfed.eval_batch(b, 64,
                                                                  seed=1)
        assert all(np.array_equal(we[k], ge[k]) for k in we)


def test_delay_draws_are_bit_identical():
    ids, ks = np.arange(40), np.arange(40) % 7
    for tag in (tdelays.TAG_DOWN, tdelays.TAG_UP, tdelays.TAG_MEAN):
        assert np.array_equal(tdelays.hash_u32(3, ids, ks, tag),
                              jdelays.hash_u32(3, ids, ks, tag))
        assert np.array_equal(tdelays.hash_u01(3, ids, ks, tag),
                              jdelays.hash_u01(3, ids, ks, tag))
    want, got = jdelays.DelayModel(9, seed=4), tdelays.DelayModel(9, seed=4)
    assert np.array_equal(want.mean_down, got.mean_down)
    assert np.array_equal(want.up_factor, got.up_factor)
    for i in (0, 3, 8, 3, 3, 0):
        assert want.sample_download(i, 1.5) == got.sample_download(i, 1.5)
        assert want.sample_upload(i) == got.sample_upload(i)
        assert want.drops(i) == got.drops(i)
    assert got.corruption_factors(np.arange(9)) is None


@pytest.mark.parametrize("kw", [
    dict(capacity=8, rows=[(0, 0), (2, 3), (5, 1)], beta=1.0, count=3),
    dict(capacity=4, rows=[(1, 2), (1, 2), (3, 0)], beta=0.5, count=3,
         damping=0.5),
    dict(capacity=16, rows=[(i, i) for i in range(10)], beta=1.0, count=10,
         damping=1.0, tau_max=6),
])
def test_admission_weights_are_bit_identical(kw):
    kw = dict(kw)
    cap, rows = kw.pop("capacity"), kw.pop("rows")
    want = j_admission_weights(cap, rows, **kw)
    got = admission_weights(cap, rows, **kw)
    assert got.dtype == np.float32 and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# server applies
# ---------------------------------------------------------------------------

def test_apply_update_matches_reference():
    params = _params()
    rng = np.random.RandomState(0)
    deltas = [jax.tree.map(lambda x: (0.01 * rng.randn(*x.shape))
                           .astype(np.float32), params) for _ in range(3)]
    jstate = j_init_server_state(jax.tree.map(jax.numpy.asarray, params))
    tstate = init_server_state(params, device="cpu")
    for delta, tau, damping in zip(deltas, (0, 4, 2), (0.0, 0.5, 1.0)):
        jstate = j_apply_update(jstate, delta, 0.9, tau, damping=damping)
        # the host rows of a materialized bank arrive as CPU tensors
        tstate = apply_update(tstate, params_from_jax(delta, "cpu"), 0.9,
                              tau, damping=damping)
    _assert_tree_close(tstate.params, jstate.params, atol=APPLY_TOL, rtol=0)
    assert int(tstate.t) == int(jstate.t) == 3
    assert tstate.staleness_sum == np.float32(jstate.staleness_sum)
    assert tstate.staleness_max == int(jstate.staleness_max)
    want, got = j_staleness_stats(jstate), staleness_stats(tstate)
    assert all(np.asarray(want[k]) == np.asarray(got[k]) for k in want)
    assert tstate.as_dict().keys() == jstate.as_dict().keys()


@pytest.mark.parametrize("m", [3, 8])
def test_apply_buffered_rows_matches_reference(m):
    params = _params()
    rng = np.random.RandomState(m)
    cap = 1 << (m - 1).bit_length()
    stack = jax.tree.map(lambda x: (0.01 * rng.randn(cap, *x.shape))
                         .astype(np.float32), params)
    rows = [(i, i % 3) for i in range(m)]
    weights = j_admission_weights(cap, rows, beta=1.0, count=m, damping=0.5)
    jstate = j_apply_buffered_rows(
        j_init_server_state(jax.tree.map(jax.numpy.asarray, params)),
        stack, weights, m, staleness_max=2, staleness_sum=float(m))
    tstate = apply_buffered_rows(init_server_state(params, device="cpu"),
                                 params_from_jax(stack, "cpu"), weights, m,
                                 staleness_max=2, staleness_sum=float(m))
    _assert_tree_close(tstate.params, jstate.params, atol=ROWS_ATOL,
                       rtol=ROWS_RTOL)
    assert int(tstate.t) == int(jstate.t) == m
    assert tstate.staleness_sum == np.float32(jstate.staleness_sum)
    assert tstate.staleness_max == int(jstate.staleness_max)


def test_apply_buffered_matches_reference():
    params = _params()
    rng = np.random.RandomState(4)
    delta_sum = jax.tree.map(lambda x: (0.05 * rng.randn(*x.shape))
                             .astype(np.float32), params)
    jstate = j_apply_buffered(
        j_init_server_state(jax.tree.map(jax.numpy.asarray, params)),
        delta_sum, 5, 0.8, staleness_max=3, staleness_sum=7.0)
    tstate = apply_buffered(init_server_state(params, device="cpu"),
                            params_from_jax(delta_sum, "cpu"), 5, 0.8,
                            staleness_max=3, staleness_sum=7.0)
    _assert_tree_close(tstate.params, jstate.params, atol=APPLY_TOL, rtol=0)
    assert int(tstate.t) == int(jstate.t) == 5
    assert tstate.staleness_sum == np.float32(jstate.staleness_sum)
    assert tstate.staleness_max == int(jstate.staleness_max)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_server_state(_params())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CohortEngine(PersAFLConfig(), lambda p, b: 0.0)


# ---------------------------------------------------------------------------
# cohort engine
# ---------------------------------------------------------------------------

PCFG = dict(q_local=2, eta=0.05, lam=25.0, inner_steps=2, inner_eta=0.02)
K_CLIENTS = 3          # not a power of two: the bucket pads one row


@functools.lru_cache(maxsize=None)
def _jax_bank(option):
    rng = np.random.RandomState(11)
    batch_list = [{"images": rng.randn(6, 4, 28, 28, 1).astype(np.float32),
                   "labels": rng.randint(0, 10, (6, 4)).astype(np.int32)}
                  for _ in range(K_CLIENTS)]
    engine = JEngine(JConfig(option=option, **PCFG),
                     lambda p, b: j_cnn_loss(J_MNIST, p, b, train=False),
                     cohort_impl="map")
    bank = engine.update_cohort(jax.tree.map(jax.numpy.asarray, _params()),
                                batch_list)
    rows = [jax.tree.map(np.asarray, r) for r in bank]
    return batch_list, rows, dict(engine.stats)


@pytest.mark.parametrize("option", ["A", "C"])
@pytest.mark.parametrize("impl", ["vmap", "map", "per-event"])
def test_cohort_bank_and_stats_match_reference(option, impl):
    batch_list, want_rows, want_stats = _jax_bank(option)
    engine = CohortEngine(
        PersAFLConfig(option=option, **PCFG),
        lambda p, b: cnn_loss(MNIST_CNN, p, b, train=False),
        vectorized=impl != "per-event",
        cohort_impl="map" if impl == "per-event" else impl, device="cpu")
    bank = engine.update_cohort(params_from_jax(_params(), "cpu"),
                                batch_list)
    assert len(bank) == K_CLIENTS
    if impl != "per-event":
        assert bank.capacity == 4
        assert engine.stats["padding_waste"] == want_stats["padding_waste"]
    for want, got in zip(want_rows, bank):
        _assert_tree_close(got, want, atol=BANK_ATOL, rtol=BANK_RTOL)
    _assert_tree_close(bank[-1], want_rows[-1], atol=BANK_ATOL,
                       rtol=BANK_RTOL)
    for key in ("cohort_calls", "clients", "max_cohort",
                "host_materializations"):
        expect = want_stats[key]
        if key == "host_materializations" and impl == "per-event":
            expect = 0       # per-event banks hold host rows from the start
        assert engine.stats[key] == expect, key


@functools.lru_cache(maxsize=None)
def _jax_mean(option, k):
    batch_list = _jax_bank(option)[0][:k]
    engine = JEngine(JConfig(option=option, **PCFG),
                     lambda p, b: j_cnn_loss(J_MNIST, p, b, train=False),
                     cohort_impl="map")
    mean = engine.update_cohort_mean(
        jax.tree.map(jax.numpy.asarray, _params()), batch_list)
    return batch_list, jax.tree.map(np.asarray, mean)


@pytest.mark.parametrize("k", [1, K_CLIENTS])
@pytest.mark.parametrize("impl", ["vmap", "map", "per-event"])
def test_cohort_mean_matches_reference(k, impl):
    """``update_cohort_mean`` against the reference's: at k = 3 the bucket
    pads a row, which must stay out of the mean."""
    batch_list, want = _jax_mean("A", k)
    engine = CohortEngine(
        PersAFLConfig(option="A", **PCFG),
        lambda p, b: cnn_loss(MNIST_CNN, p, b, train=False),
        vectorized=impl != "per-event",
        cohort_impl="map" if impl == "per-event" else impl, device="cpu")
    got = engine.update_cohort_mean(params_from_jax(_params(), "cpu"),
                                    batch_list)
    _assert_tree_close(got, want, atol=BANK_ATOL, rtol=BANK_RTOL)
    assert engine.stats["clients"] == k
    with pytest.raises(ValueError):
        engine.update_cohort_mean(params_from_jax(_params(), "cpu"), [])
