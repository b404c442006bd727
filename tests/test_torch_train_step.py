"""Port of the train half of ``launch/steps.py`` (``microbatched``,
``make_loss``, ``_q_batches``, ``make_train_step``,
``make_cohort_train_step``) against ``repro.launch.steps``.

``check_train_step`` runs one PersA-FL round of ``make_train_step`` (Q = 2
local steps, K = 2 inner steps for Option C) at ``reduce_for_smoke`` of an
arch in both packages: one seeded init as numpy arrays for both,
numpy batches (B 2, S 32; whisper with unit-normal frames) through both, and
the JAX step compiled by ``jax.jit`` as the reference's driver runs it (with
XLA's backend optimizations off, for time).  This file runs the dense
gemma2-2b under Options A and C; one file a family runs the rest, each within
~20 s alone: ``test_torch_train_step_{ssm,hybrid,moe,encdec}.py`` (mamba2-130m,
zamba2-1.2b, granite-moe-1b-a400m, whisper-large-v3, Options A and C) and
``test_torch_train_step_maml.py`` (gemma2-2b under Option B with
``maml_mode="full"``).

Tolerances, as ``tests/test_torch_ssm_lm.py``: the round's change of the
params (new − old) within 1e-5 absolute plus 1e-5 relative, the metrics
(``delta_norm``, ``grad_norm_mean``, ``nu_mean``) within rtol 1e-5, the
microbatched loss within rtol 1e-5 and its gradient within rtol 1e-4 and
atol 1e-6 (the reference's own test allows atol 2e-5 and rtol 2e-3).  Each
float comparison also shows that a zero and a sign-flipped result fail it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro import configs as jconfigs
from repro.core import PersAFLConfig as JConfig
from repro.data import synthetic_token_batch as j_tokens
from repro.launch import steps as jsteps
from repro_torch import configs
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import PersAFLConfig
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.tree import tree_leaves, tree_map

ATOL = RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
B, S = 2, 32
PCFG = dict(q_local=2, eta=0.01, lam=30.0, inner_steps=2, inner_eta=0.03,
            alpha=0.01)
XLA_FAST = {"xla_backend_optimization_level": 0}



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


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA's backend (LLVM)
    optimizations off: the same HLO, half the compile time of a smoke step
    (zamba2's Option C 13.2 → 7.4 s on the CPU)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=XLA_FAST)


def _setup(arch, seed=0):
    """Both packages' smoke configs, one init as numpy (the port's, drawn
    from a seeded generator: the same arrays go to both packages, and no
    JAX init is compiled) and one batch."""
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    cfg = configs.reduce_for_smoke(configs.get_config(arch))
    np_params = params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    batch = j_tokens(seed + 1, B, S, cfg.vocab)
    if cfg.is_encdec:
        batch["frames"] = np.random.RandomState(seed).randn(
            B, cfg.enc_len, cfg.d_model).astype(np.float32)
    return jcfg, cfg, np_params, batch


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in tree])


def check_train_step(arch, option, maml_mode=None):
    """One round of ``make_train_step`` at ``arch``'s smoke config under
    ``option`` in both packages (``maml_mode`` defaults to the config's)."""
    jcfg, cfg, np_params, batch = _setup(arch)
    mode = maml_mode or cfg.maml_mode
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jnew, jm = _compiled(jsteps.make_train_step(
        jcfg, JConfig(option=option, maml_mode=mode, **PCFG), 1),
        np_params, np_params, jbatch)(np_params, np_params, jbatch)
    params = params_from_jax(np_params, device="cpu")
    step = steps.make_train_step(
        cfg, PersAFLConfig(option=option, maml_mode=mode, **PCFG), 1)
    new, m = step(params, params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    old = _flat(jax.tree.leaves(np_params))
    _holds(_flat(x.numpy() for x in tree_leaves(new)) - old,
           _flat(np.asarray(x) for x in jax.tree.leaves(jnew)) - old)
    for x, p in zip(tree_leaves(new), tree_leaves(params)):
        assert x.dtype == p.dtype and x.shape == p.shape
    keys = ("delta_norm", "grad_norm_mean") + (("nu_mean",)
                                               if option == "C" else ())
    for key in keys:
        _holds(float(m[key]), float(jm[key]), atol=0.0)


@pytest.mark.parametrize("option", ["A", "C"])
def test_train_step_matches_reference(option):
    check_train_step("gemma2-2b", option)


def test_microbatched_grad_matches_reference():
    """tests/test_launch.py's minitron case: 4 slices of a (4, 16) batch."""
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config("minitron-8b"))
    cfg = configs.reduce_for_smoke(configs.get_config("minitron-8b"))
    np_params = params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    jparams = jax.tree.map(jnp.asarray, np_params)
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (4, 16)).astype(
        np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss = jsteps.make_loss(jcfg, 4)
    want_loss, want = _compiled(jax.value_and_grad(jloss), jparams,
                                jbatch)(jparams, jbatch)
    want_loss, want = float(want_loss), jax.tree.leaves(want)
    params = params_from_jax(np_params, "cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)}
    loss = steps.make_loss(cfg, 4)
    _holds(float(loss(params, batch)), want_loss, atol=0.0)
    got = tree_leaves(grad(loss)(params, batch))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _holds(a.numpy(), np.asarray(b), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # accumulation over the slices is the full batch's gradient
    full = tree_leaves(grad(steps.make_loss(cfg, 1))(params, batch))
    for a, b in zip(got, full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-3)
    assert steps.microbatched(loss, 1) is loss


def test_q_batches_broadcast_without_copy():
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    tiled = steps._q_batches(PersAFLConfig(option="C", q_local=4), {"t": x})
    assert tiled["t"].shape == (4, 2, 3)
    assert tiled["t"].data_ptr() == x.data_ptr()
    assert tiled["t"].stride(0) == 0
    b = steps._q_batches(PersAFLConfig(option="B", q_local=3), {"t": x})
    assert sorted(b) == ["d", "dp", "dpp"]
    assert all(torch.equal(b[k]["t"][2], x) for k in b)


def test_train_step_applies_at_stale_params():
    """tests/test_launch.py:31-52: the server moves by −βΔ, and a delta
    computed at other (stale) params gives another new model."""
    cfg = configs.reduce_for_smoke(configs.get_config("codeqwen1.5-7b"))
    params = api.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    pcfg = PersAFLConfig(option="A", q_local=2, eta=0.01, beta=1.0)
    step = steps.make_train_step(cfg, pcfg, n_microbatches=1)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    before = [x.clone() for x in tree_leaves(params)]
    new_params, metrics = step(params, params, batch)
    # out of place: the tree handed in as server and stale is untouched
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(params)))
    moved = sum(float((a - b).abs().sum()) for a, b in
                zip(tree_leaves(params), tree_leaves(new_params)))
    assert moved > 0
    stale = tree_map(lambda x: x + 0.01 if x.dim() >= 2 else x, params)
    new2, _ = step(params, stale, batch)
    diff = sum(float((a - b).abs().sum()) for a, b in
               zip(tree_leaves(new_params), tree_leaves(new2)))
    assert diff > 0
    # β scales the apply: half the step moves the server half as far
    half = steps.make_train_step(cfg, dataclasses.replace(pcfg, beta=0.5),
                                 1)(params, params, batch)[0]
    for w, n1, nh in zip(tree_leaves(params), tree_leaves(new_params),
                         tree_leaves(half)):
        np.testing.assert_allclose((w - nh).numpy(), 0.5 * (w - n1).numpy(),
                                   atol=1e-7, rtol=1e-5)


def test_cohort_train_step_names_the_multi_device_queue():
    """The cohort step is ported (tests/test_torch_cohort_train_step.py runs
    it on spawned ranks); its mesh needs a process group, which the pytest
    process never starts, and building one without it says how to start
    one."""
    import torch.distributed as dist

    from repro_torch.launch import mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh.make_host_mesh()
    # building the step reads only the mesh's axis names
    cfg = configs.reduce_for_smoke(configs.get_config("mamba2-130m"))
    names = type("Mesh", (), {"mesh_dim_names": ("data", "model")})()
    assert callable(steps.make_cohort_train_step(cfg, PersAFLConfig(),
                                                 mesh=names))
