"""``client_update`` under Option B with ``maml_mode="full"`` through the
SSD scan: the exact Hessian-vector product (``torch.func.jvp`` of
``torch.func.grad``) runs forward mode through ``SSDScan``'s jvp rule (the
jvp of the plain ``ssd_chunked``), as the reference differentiates
``ssd_chunked`` in either mode.  On the CPU the models scan with the plain
``ssd_chunked``, so ``kernel_scan`` routes every Mamba2 block through
``SSDScan`` (its sequential-oracle forward) as the card does.  At
``reduce_for_smoke`` of mamba2-130m (the zamba2 hybrid:
``tests/test_torch_train_step_maml_hybrid.py``), from the JAX init (the
reference's ``init_params`` under ``jax.jit``) carried across by
``params_from_jax``, on the same numpy batches (Q = 1, B 1, S 16,
one chunk) in both packages.  Tolerances, as ``tests/test_torch_ssm_lm.py``'s for gradients:
the delta within rtol 1e-4 and atol 1e-6, the metrics within rtol 1e-5;
each comparison also shows that a zero and a sign-flipped result fail it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import PersAFLConfig as JConfig
from repro.core import client_update as j_client_update
from repro.data import synthetic_token_batch as j_tokens
from repro.models import api as japi
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core import PersAFLConfig, client_update
from repro_torch.models import api, mamba2, ssm_lm
from repro_torch.models.mamba2 import SSDScan, ssd_chunked
from repro_torch.tree import tree_leaves
from test_torch_train_step import _one_torch_thread  # noqa: F401

GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
PCFG = dict(option="B", maml_mode="full", q_local=1, eta=0.01, alpha=0.01)
XLA_FAST = {"xla_backend_optimization_level": 0}


def _holds(got, want, atol, rtol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    assert not np.allclose(np.zeros_like(want), want, atol=atol, rtol=rtol)
    assert not np.allclose(-want, want, atol=atol, rtol=rtol)


def _batches(vocab):
    """Option B's three batches D, D', D'' (Q = 1, B 1, S 16), numpy."""
    out = {}
    for i, key in enumerate(("d", "dp", "dpp")):
        b = j_tokens(7 + i, 1, 16, vocab)
        out[key] = {k: v[None] for k, v in b.items()}
    return out


@pytest.fixture
def kernel_scan(monkeypatch):
    """Every Mamba2 block scans through ``SSDScan``, as on the card."""
    real = mamba2.mamba2_forward
    monkeypatch.setattr(ssm_lm.m2, "mamba2_forward",
                        lambda cfg, p, x, use_kernel=False:
                        real(cfg, p, x, use_kernel=True))


def check_option_b_full(arch):
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    cfg = configs.reduce_for_smoke(configs.get_config(arch))
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(lambda k: japi.init_params(jcfg, k)).lower(key).compile(
        compiler_options=XLA_FAST)(key)
    np_params = jax.tree.map(np.asarray, jparams)
    batches = _batches(cfg.vocab)

    def jstep(p, b):
        return j_client_update(JConfig(**PCFG),
                               lambda pp, bb: japi.loss_fn(jcfg, pp, bb),
                               p, b)
    jb = jax.tree.map(jnp.asarray, batches)
    jdelta, jm = jax.jit(jstep).lower(jparams, jb).compile(
        compiler_options=XLA_FAST)(jparams, jb)

    params = params_from_jax(np_params, device="cpu")
    tb = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in batches.items()}
    delta, m = client_update(PersAFLConfig(**PCFG),
                             lambda p, b: api.loss_fn(cfg, p, b), params, tb)
    got = np.concatenate([x.numpy().ravel() for x in tree_leaves(delta)])
    want = np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(jdelta)])
    _holds(got, want, GRAD_ATOL, GRAD_RTOL)
    for key in ("delta_norm", "grad_norm_mean"):
        _holds(float(m[key]), float(jm[key]), 0.0, 1e-5)


def test_option_b_full_matches_reference(kernel_scan):
    check_option_b_full("mamba2-130m")


def _scan_inputs(seed=0, B=2, S=32, H=4, P=8, N=16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.5 + 0.05
    a_log = torch.randn(H, generator=g) * 0.5
    Bm = torch.randn(B, S, 1, N, generator=g)
    Cm = torch.randn(B, S, 1, N, generator=g)
    return x, dt, a_log, Bm, Cm


def test_jvp_rule_is_the_jvp_of_ssd_chunked_under_vmap():
    """The jvp rule alone and composed with the vmap rule (a cohort of
    users, each with its own ``a_log``), against the jvp of the plain scan
    at rtol 1e-4, atol 1e-6."""
    prim = _scan_inputs(0)
    tang = _scan_inputs(1)
    chunk = 16
    got = torch.func.jvp(lambda *a: SSDScan.apply(*a, chunk), prim, tang)[1]
    want = torch.func.jvp(lambda *a: ssd_chunked(*a, chunk=chunk), prim,
                          tang)[1]
    _holds(got.numpy(), want.numpy(), GRAD_ATOL, GRAD_RTOL)
    V = 3
    vp = [torch.stack([p * (1 + 0.1 * v) for v in range(V)]) for p in prim]
    vt = [torch.stack([t * (1 - 0.1 * v) for v in range(V)]) for t in tang]

    def one(scan):
        return lambda p, t: torch.func.jvp(scan, tuple(p), tuple(t))[1]
    got = torch.func.vmap(one(lambda *a: SSDScan.apply(*a, chunk)))(vp, vt)
    want = torch.func.vmap(one(lambda *a: ssd_chunked(*a, chunk=chunk)))(
        vp, vt)
    _holds(got.numpy(), want.numpy(), GRAD_ATOL, GRAD_RTOL)


def test_option_b_full_runs_through_ssd_scan(kernel_scan):
    """The HVP reaches ``SSDScan`` (not a plain scan): without its jvp rule
    forward mode raises."""
    cfg = configs.reduce_for_smoke(configs.get_config("mamba2-130m"))
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 1, 16), dtype=torch.int32)
    b = {"tokens": toks, "labels": toks}
    pcfg = PersAFLConfig(option="B", q_local=1, maml_mode="full")
    real = mamba2.SSDScan.jvp
    try:
        del mamba2.SSDScan.jvp
        with pytest.raises(NotImplementedError, match="jvp"):
            client_update(pcfg, lambda p, bb: api.loss_fn(cfg, p, bb),
                          params, {"d": b, "dp": b, "dpp": b})
    finally:
        mamba2.SSDScan.jvp = real
