"""Port of Algorithm 2's client update (``repro_torch.core.client``, with
``core/maml.py`` and ``core/moreau.py`` under it) against ``repro.core``:
Options A, B (``full``, ``fo``, ``hf``) and C on the paper's MNIST CNN, from
the JAX init and the same numpy batches.  The delta and the three metrics
are compared.

Tolerances: delta 2e-6 absolute with 1e-4 relative, metrics 1e-4 relative.
Each local step sums f32 convolutions in another order than XLA does, and
Option C chains inner_steps + 1 gradients per step; HF-MAML divides a
difference of two gradients by 2δ = 0.02, which magnifies that noise fifty
times before α scales it back down.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import MNIST_CNN as J_MNIST
from repro.core import PersAFLConfig as JConfig
from repro.core import client_update as j_client_update
from repro.core import personalize_maml as j_personalize_maml
from repro.core import personalize_me as j_personalize_me
from repro.core import split_batches_for_option as j_split
from repro.models.cnn import cnn_loss as j_cnn_loss
from repro.models.cnn import init_cnn as j_init_cnn
from repro_torch.configs.paper_models import MNIST_CNN
from repro_torch.convert import params_from_jax
from repro_torch.core import (PersAFLConfig, client_update,
                              personalize_maml, personalize_me)
from repro_torch.core import split_batches_for_option
from repro_torch.models.cnn import cnn_loss
from repro_torch.tree import tree_leaves, tree_map

DELTA_ATOL, DELTA_RTOL = 2e-6, 1e-4
METRIC_RTOL = 1e-4
CASES = [("A", "full"), ("B", "full"), ("B", "fo"), ("B", "hf"),
         ("C", "full")]
PCFG = dict(q_local=2, eta=0.05, alpha=0.02, lam=25.0, inner_steps=3,
            inner_eta=0.02)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the shapes are small: one intra-op thread runs them faster and leaves
    # the cores to the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _inputs():
    jparams = jax.tree.map(np.asarray, jax.jit(j_init_cnn, static_argnums=0)(
        J_MNIST, jax.random.PRNGKey(3)))
    rng = np.random.RandomState(5)
    q3 = 3 * PCFG["q_local"]
    batches = {"images": rng.randn(q3, 4, 28, 28, 1).astype(np.float32),
               "labels": rng.randint(0, 10, (q3, 4)).astype(np.int32)}
    return jparams, batches


def _jax_loss(p, b):
    return j_cnn_loss(J_MNIST, p, b, train=False)


def _torch_loss(p, b):
    return cnn_loss(MNIST_CNN, p, b, train=False)


@pytest.mark.parametrize("option,mode", CASES)
def test_client_update_matches_reference(option, mode):
    jparams, batches = _inputs()
    jcfg = JConfig(option=option, maml_mode=mode, **PCFG)
    tcfg = PersAFLConfig(option=option, maml_mode=mode, **PCFG)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jdelta, jmet = jax.jit(lambda p, b: j_client_update(
        jcfg, _jax_loss, p, j_split(option, b)))(jparams, batches)
    tbatches = tree_map(torch.from_numpy, batches)
    tdelta, tmet = client_update(
        tcfg, _torch_loss, params_from_jax(jparams, "cpu"),
        split_batches_for_option(option, tbatches))
    for a, b in zip(jax.tree.leaves(jdelta), tree_leaves(tdelta)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=DELTA_ATOL, rtol=DELTA_RTOL)
    for key in ("grad_norm_mean", "delta_norm", "nu_mean"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=METRIC_RTOL, atol=1e-7)


def test_delta_dtype_bfloat16_is_carried():
    jparams, batches = _inputs()
    tcfg = PersAFLConfig(option="A", delta_dtype="bfloat16", **PCFG)
    tdelta, _ = client_update(
        tcfg, _torch_loss, params_from_jax(jparams, "cpu"),
        split_batches_for_option("A", tree_map(torch.from_numpy, batches)))
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(tdelta))


@pytest.mark.parametrize("option", ["A", "B", "C"])
def test_split_batches_matches_reference(option):
    _, batches = _inputs()
    want = j_split(option, batches)
    got = split_batches_for_option(option, tree_map(torch.from_numpy,
                                                    batches))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("kind", ["maml", "me"])
def test_personalize_matches_reference(kind):
    """The evaluation-side fine-tunes: one MAML step (Option B) and the
    Moreau prox solution θ̃ (Option C)."""
    jparams, batches = _inputs()
    jb = {k: v[0] for k, v in batches.items()}
    if kind == "maml":
        want = jax.jit(lambda p, b: j_personalize_maml(
            _jax_loss, p, b, 0.05))(jparams, jb)
        got = personalize_maml(_torch_loss, params_from_jax(jparams, "cpu"),
                               tree_map(torch.from_numpy, jb), 0.05)
    else:
        want = jax.jit(lambda p, b: j_personalize_me(
            _jax_loss, p, b, 25.0, 0.02, 3))(jparams, jb)
        got = personalize_me(_torch_loss, params_from_jax(jparams, "cpu"),
                             tree_map(torch.from_numpy, jb), 25.0, 0.02, 3)
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=DELTA_ATOL, rtol=DELTA_RTOL)
