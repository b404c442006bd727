"""Port of the paper CNN (``repro_torch.models.cnn``) against
``repro.models.cnn``: the same params (the JAX init, carried across with
``params_from_jax``) and the same numpy images give the same logits, loss,
gradients and accuracy, for both paper models.

Tolerances: logits and loss 1e-5 absolute (f32 convolutions and products
summed in other orders by XLA and by PyTorch on the CPU); gradients 1e-5
absolute with 1e-4 relative, for the same reason.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JPM
from repro.models import cnn as jcnn
from repro_torch.configs import paper_models as PM
from repro_torch.convert import params_from_jax
from repro_torch.models import cnn as tcnn
from repro_torch.tree import tree_leaves

ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
CONFIGS = {"mnist": (JPM.MNIST_CNN, PM.MNIST_CNN),
           "cifar": (JPM.CIFAR_CNN, PM.CIFAR_CNN)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the shapes are small: one intra-op thread runs them faster and leaves
    # the cores to the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_init(kind):
    # jitted: one compile instead of one per eager op of the init
    return jax.jit(jcnn.init_cnn, static_argnums=0)(CONFIGS[kind][0],
                                                    jax.random.PRNGKey(0))


def _setup(kind, batch=6):
    jcfg, tcfg = CONFIGS[kind]
    jparams = _jax_init(kind)
    rng = np.random.RandomState(1)
    images = rng.randn(batch, jcfg.image_size, jcfg.image_size,
                       jcfg.channels).astype(np.float32)
    labels = rng.randint(0, 10, batch).astype(np.int32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tbatch = {"images": torch.from_numpy(images),
              "labels": torch.from_numpy(labels)}
    return jcfg, tcfg, jparams, tparams, {"images": images,
                                          "labels": labels}, tbatch


def test_configs_match_reference():
    for jcfg, tcfg in CONFIGS.values():
        assert jcfg.__dict__ == tcfg.__dict__
    n = sum(x.numel() for x in tree_leaves(
        tcnn.init_cnn(PM.MNIST_CNN, torch.Generator().manual_seed(0))))
    assert n == 52138


@pytest.mark.parametrize("kind", ["mnist", "cifar"])
def test_init_has_reference_tree_shapes_and_dtypes(kind):
    jcfg, tcfg = CONFIGS[kind]
    shapes = jax.eval_shape(lambda: jcnn.init_cnn(jcfg,
                                                  jax.random.PRNGKey(0)))
    tparams = tcnn.init_cnn(tcfg, torch.Generator().manual_seed(0))
    jl, tl = jax.tree.leaves(shapes), tree_leaves(tparams)
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    assert all(x.dtype == torch.float32 for x in tl)
    # a truncated normal at ±2σ, scaled by 0.1 for the convs
    w = tparams["conv"][0]["w"]
    assert float(w.abs().max()) <= 0.2 + 1e-7


@functools.lru_cache(maxsize=None)
def _jax_outputs(kind):
    """Logits, loss, accuracy and loss gradients of the reference, in one
    jitted call per model."""
    jcfg = CONFIGS[kind][0]
    _, _, jparams, _, jb, _ = _setup(kind)

    @jax.jit
    def outputs(p, b):
        loss = lambda q: jcnn.cnn_loss(jcfg, q, b, train=False)  # noqa: E731
        return (jcnn.cnn_logits(jcfg, p, b["images"]), loss(p),
                jcnn.cnn_accuracy(jcfg, p, b), jax.grad(loss)(p))
    return jax.tree.map(np.asarray, outputs(jparams, jb))


@pytest.mark.parametrize("kind", ["mnist", "cifar"])
def test_logits_loss_accuracy_match(kind):
    _, tcfg, _, tparams, _, tb = _setup(kind)
    logits, loss, acc, _ = _jax_outputs(kind)
    got = tcnn.cnn_logits(tcfg, tparams, tb["images"]).numpy()
    np.testing.assert_allclose(got, logits, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        float(tcnn.cnn_loss(tcfg, tparams, tb, train=False)), float(loss),
        atol=ATOL)
    assert float(tcnn.cnn_accuracy(tcfg, tparams, tb)) == float(acc)


@pytest.mark.parametrize("kind", ["mnist", "cifar"])
def test_loss_gradients_match(kind):
    _, tcfg, _, tparams, _, tb = _setup(kind)
    jg = _jax_outputs(kind)[3]
    tg = torch.func.grad(
        lambda p: tcnn.cnn_loss(tcfg, p, tb, train=False))(tparams)
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        np.testing.assert_allclose(b.numpy(), a, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_dropout_only_in_training_with_a_generator():
    _, tcfg, _, tparams, _, tb = _setup("mnist")
    base = tcnn.cnn_logits(tcfg, tparams, tb["images"])
    same = tcnn.cnn_logits(tcfg, tparams, tb["images"], train=True)
    torch.testing.assert_close(base, same, rtol=0, atol=0)
    dropped = tcnn.cnn_logits(tcfg, tparams, tb["images"], train=True,
                              generator=torch.Generator().manual_seed(0))
    assert not torch.equal(base, dropped)
