"""Port of the hybrid language model (zamba2: ``repro_torch.models.ssm_lm``
with its shared attention block, ``models.api``, ``convert``, the checkpoint
store) against the JAX package at ``reduce_for_smoke(zamba2-1.2b)`` cut to
4 layers (d 256, 4 heads of 32, d_ff 1024, vocab 512, state 16, chunk 16,
window 16, ``attn_every`` 2: two invocations of the shared block, after
layers 1 and 3; f32): the JAX init carried across by ``params_from_jax`` and
numpy token streams through both.

Tolerances, as ``test_torch_ssm_lm.py``: the loss within rtol 1e-5;
gradients within rtol 1e-4 and atol 1e-6; logits and caches (order 1)
within 1e-5 absolute plus 1e-5 relative.  Each float comparison also shows
that a zero and a sign-flipped result fail it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.configs import base as jbase
from repro.models import api as japi
from repro_torch import configs
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import base
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.subset import leaf_paths
from repro_torch.data import synthetic_token_batch
from repro_torch.launch import steps
from repro_torch.models import api, ssm_lm
from repro_torch.tree import tree_leaves, tree_map

ATOL = RTOL = 1e-5
SEQ, LAYERS, DECODE = 32, 4, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _holds(got, want, atol=ATOL, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    assert not np.allclose(np.zeros_like(want), want, atol=atol, rtol=rtol)
    assert not np.allclose(-want, want, atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(
        jbase.reduce_for_smoke(jconfigs.get_config("zamba2-1.2b")),
        n_layers=LAYERS)
    cfg = dataclasses.replace(
        base.reduce_for_smoke(configs.get_config("zamba2-1.2b")),
        n_layers=LAYERS)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_params, device="cpu")
    batch = synthetic_token_batch(1, 2, SEQ, cfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, jbatch)))(jparams)
    oracle = {"loss": np.asarray(loss), "grad": jax.tree.map(np.asarray, g),
              "prefill": np.asarray(jax.jit(lambda p: japi.prefill_logits(
                  jcfg, p, jbatch))(jparams))}
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_params=np_params,
                params=params, batch=batch, tbatch=tbatch, oracle=oracle)


def test_smoke_config_and_full_count():
    full = configs.get_config("zamba2-1.2b")
    assert full.n_params == jconfigs.get_config("zamba2-1.2b").n_params \
        == 1_182_649_344
    red = base.reduce_for_smoke(full)
    assert (red.attn_every, red.sliding_window, red.n_layers) == (2, 16, 2)
    assert ssm_lm.n_shared_slots(full) == 6
    assert [i for i in range(full.n_layers)
            if ssm_lm._is_shared_layer(full, i)] == [5, 11, 17, 23, 29, 35]
    # the published width's leaves, from the reference's own init shapes
    shapes = jax.eval_shape(lambda k: japi.init_params(
        jconfigs.get_config("zamba2-1.2b"), k), jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(shapes)
    assert len(leaves) == 21
    assert sum(int(np.prod(x.shape)) for x in leaves) == 1_183_058_816


def test_param_tree_structure_and_count(smoke):
    cfg, np_params, params = smoke["cfg"], smoke["np_params"], smoke["params"]
    jleaves = jax.tree_util.tree_leaves_with_path(np_params)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves) == 21
    assert list(leaf_paths(params)) == sorted(
        "/".join(k.key for k in path) for path, _ in jleaves)
    for (path, a), t in zip(jleaves, leaves):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), a)
    own = ssm_lm.init_ssm_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tree_map(lambda x: (tuple(x.shape), x.dtype), own) == \
        tree_map(lambda x: (tuple(x.shape), x.dtype), params)


def test_shared_subtree_carries_across_checkpoints(smoke, tmp_path):
    """The ``shared`` subtree goes both ways: saved by the port and loaded by
    the JAX store, saved by the JAX store and loaded by the port, and back
    to the JAX layout through ``params_to_numpy``."""
    np_params = smoke["np_params"]
    tstore.save_pytree(str(tmp_path / "port.npz"), smoke["params"])
    jstore.save_pytree(str(tmp_path / "jax.npz"), np_params)
    for tree in (jstore.load_pytree(str(tmp_path / "port.npz")),
                 tstore.load_pytree(str(tmp_path / "jax.npz")),
                 params_to_numpy(smoke["params"])):
        assert sorted(tree["shared"]) == ["attn", "ln_in", "ln_mlp", "mlp"]
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(np_params)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_loss_and_gradient_match_reference(smoke):
    cfg, params, tbatch = smoke["cfg"], smoke["params"], smoke["tbatch"]
    oracle = smoke["oracle"]
    loss = api.loss_fn(cfg, params, tbatch)
    _holds(loss, oracle["loss"], atol=0.0, rtol=1e-5)
    g = grad(lambda p: api.loss_fn(cfg, p, tbatch))(params)
    assert sorted(g["shared"]) == ["attn", "ln_in", "ln_mlp", "mlp"]
    for a, b in zip(tree_leaves(g), jax.tree.leaves(oracle["grad"])):
        _holds(a, b, atol=1e-6, rtol=1e-4)


def test_prefill_logits_match_reference(smoke):
    cfg, params = smoke["cfg"], smoke["params"]
    got = steps.make_prefill_step(cfg)(params, smoke["tbatch"])
    assert tuple(got.shape) == (2, cfg.vocab)
    _holds(got, smoke["oracle"]["prefill"])


def test_decode_steps_past_the_window_match_reference(smoke):
    """24 decode steps from an empty cache with a 16-slot attention ring
    (max_len 32, window 16): the ring wraps after step 15.  Logits at every
    step and the whole cache after the last."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    tokens = np.concatenate([smoke["batch"]["tokens"]] * 2, axis=1)
    jcache = japi.init_cache(jcfg, smoke["jparams"],
                             {"tokens": jnp.asarray(tokens[:, :1])}, 32,
                             jnp.float32)
    cache = api.init_cache(cfg, smoke["params"],
                           {"tokens": torch.from_numpy(tokens[:, :1])}, 32,
                           torch.float32)
    assert tree_map(lambda x: tuple(x.shape), cache) == \
        jax.tree.map(lambda x: tuple(x.shape), jcache)
    assert cache["emb0"] is None
    assert tuple(cache["attn"]["k"].shape) == (2, 2, 16, 4, 32)
    step = steps.make_serve_step(cfg)
    jstep = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t,
                                                          pos))
    for pos in range(DECODE):
        tok = tokens[:, pos:pos + 1]
        jl, jcache = jstep(smoke["jparams"], jcache, jnp.asarray(tok),
                           jnp.int32(pos))
        logits, cache = step(smoke["params"], cache, torch.from_numpy(tok),
                             pos)
        assert tuple(logits.shape) == (2, 1, cfg.vocab)
        _holds(logits, jl)
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        _holds(a, b)
