"""``launch/steps.py``'s ``make_cohort_train_step`` on 2 spawned ``gloo``
ranks (``tests/torch_ranks.py``; no process group in the pytest process);
its one-rank case is ``tests/test_torch_one_rank_mesh.py``'s.

At 2 ranks over a ``(2, 1)`` ("data", "model") mesh at mamba2-130m's
  smoke config from the JAX init (Option A, Q = 2, B 2, S 16): each rank is
  one client on its row of the batch, and the new params are within 1e-6 of
  the JAX package's two ``client_update`` deltas (one a row) averaged and
  applied with β.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import PersAFLConfig as JConfig
from repro.core import client_update as j_client_update
from repro.models import api as japi
from torch_ranks import spawn

PCFG = dict(option="A", q_local=2, eta=0.01)
XLA_FAST = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("cohort_step_ranks")
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config("mamba2-130m"))
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 16)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": toks}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({"arch": "mamba2-130m", "pcfg": PCFG, "batch": batch,
                     "params": jax.tree.map(np.asarray, jparams)}, f)
    ranks = spawn("cohort_step", 2, out, timeout_s=120)

    def one(p, b):
        q = jax.tree.map(lambda x: jnp.broadcast_to(
            x[None], (PCFG["q_local"],) + x.shape), b)
        return j_client_update(JConfig(**PCFG),
                               lambda pp, bb: japi.loss_fn(jcfg, pp, bb),
                               p, q)
    rows = [{k: jnp.asarray(v[i:i + 1]) for k, v in batch.items()}
            for i in range(2)]
    fn = jax.jit(one).lower(jparams, rows[0]).compile(
        compiler_options=XLA_FAST)
    outs = [fn(jparams, r) for r in rows]
    beta = JConfig(**PCFG).beta
    want = jax.tree.map(
        lambda w, a, b: np.asarray(
            (w.astype(jnp.float32) - beta * (a + b) / 2).astype(w.dtype)),
        jparams, outs[0][0], outs[1][0])
    metrics = {k: (float(outs[0][1][k]) + float(outs[1][1][k])) / 2
               for k in outs[0][1]}
    return ranks, jax.tree.map(np.asarray, jparams), want, metrics


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def test_cohort_step_at_two_ranks_is_the_mean_of_two_clients(two_ranks):
    ranks, old, want, _ = two_ranks
    got, want, old = _flat(ranks[0]["new"]), _flat(want), _flat(old)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the round moved the params by more than the tolerance, and a
    # sign-flipped move fails it
    assert np.abs(want - old).max() > 1e-4
    assert not np.allclose(2 * old - want, want, atol=1e-6, rtol=0)


def test_cohort_step_ranks_agree(two_ranks):
    ranks = two_ranks[0]
    np.testing.assert_array_equal(_flat(ranks[1]["new"]),
                                  _flat(ranks[0]["new"]))
    assert ranks[1]["metrics"] == ranks[0]["metrics"]


def test_cohort_step_metrics_are_the_clients_mean(two_ranks):
    ranks, _, _, metrics = two_ranks
    for k, v in metrics.items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-5)
