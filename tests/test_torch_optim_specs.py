"""Port of ``optim/`` and ``launch/specs.py`` (``repro_torch.optim``,
``repro_torch.launch.specs``) against ``repro.optim`` and
``repro.launch.specs``.

Optimizers: ``sgd`` (constant and cosine schedules), ``momentum`` and
``adam`` run 5 steps on one tree of f32 and bf16 leaves from the same numpy
gradients in both packages, ``apply_updates`` folding each step into the
params: updates, state and params within 1e-6 absolute plus 1e-6 relative
(f32 arithmetic on both sides; XLA's and torch's ``cos``, ``sqrt`` and
``pow`` may differ by an ulp), the step counter exactly, bf16 params within
one bf16 ulp of 1 (2^-7, relative).  Each float comparison also shows that a
zero and a sign-flipped result fail it.

Specs: the uncast ``params_struct`` (the init's own tree) against the
reference's on mamba2-130m, zamba2-1.2b, gemma2-2b and granite-moe-1b-a400m
at their published configs, the same tree paths, shapes and dtypes exactly,
every leaf a meta tensor; ``cast_params`` against ``params_struct``'s dtype
policy.  ``tests/test_torch_specs.py`` holds the four spec functions for all
ten archs (the two files split for time: the reference's ``eval_shape`` of a
deep arch's init takes ~1 s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.launch import specs as jspecs
from repro_torch import configs, optim
from repro_torch.launch import specs
from repro_torch.models import api
from repro_torch.tree import tree_leaves

ATOL = RTOL = 1e-6
BF16_RTOL = 2.0 ** -7
STEPS = 5
# the reference's eval_shape of an init takes ~1 s for the deep archs, so
# the uncast trees are held on these four (ssm, hybrid, dense, moe)
UNCAST_ARCHS = ("mamba2-130m", "zamba2-1.2b", "gemma2-2b",
                "granite-moe-1b-a400m")


def _holds(got, want, atol=ATOL, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    assert not np.allclose(np.zeros_like(want), want, atol=atol, rtol=rtol)
    assert not np.allclose(-want, want, atol=atol, rtol=rtol)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(8, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32),
              "h": [rng.randn(3, 4).astype(np.float32)]}
    grads = [{"w": rng.randn(8, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32),
              "h": [rng.randn(3, 4).astype(np.float32)]}
             for _ in range(STEPS)]
    return params, grads


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(0.1)),
    "sgd_cosine": (lambda m: m.sgd(m.cosine_lr(0.1, STEPS, warmup=2))),
    "momentum": (lambda m: m.momentum(0.05, beta=0.9)),
    "adam": (lambda m: m.adam(0.01)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_optimizer_steps_match_reference(name, bf16):
    params, grads = _tree()
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), params)
    tp = jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), params)
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](optim)
    js, ts = jopt.init(jp), topt.init(tp)
    got, want = [], []       # every step's updates (the cosine's first is 0)
    for g in grads:
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), g)
        tg = jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), g)
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        for a, b in zip(jax.tree.leaves(ju), tree_leaves(tu)):
            assert b.dtype == torch.float32
            got.append(_np(b).ravel())
            want.append(_np(a).ravel())
        jp = joptim.apply_updates(jp, ju)
        tp = optim.apply_updates(tp, tu)
    _holds(np.concatenate(got), np.concatenate(want))
    assert int(ts["step"]) == int(js["step"]) == STEPS
    assert ts["step"].dtype == torch.int32
    for key in ("m", "v"):
        if key in js:
            for a, b in zip(jax.tree.leaves(js[key]),
                            tree_leaves(ts[key])):
                assert b.dtype == torch.float32
                _holds(_np(b), _np(a))
    for a, b, p0 in zip(jax.tree.leaves(jp),
                        tree_leaves(tp),
                        jax.tree.leaves(params)):
        assert b.dtype == tdt
        if bf16:
            np.testing.assert_allclose(_np(b), _np(a), rtol=BF16_RTOL,
                                       atol=0)
        else:
            _holds(_np(b) - p0, _np(a) - p0)


def test_cosine_schedule_matches_reference():
    jsched = joptim.cosine_lr(0.1, 20, warmup=4)
    tsched = optim.cosine_lr(0.1, 20, warmup=4)
    got = np.array([float(tsched(torch.tensor(s, dtype=torch.int32)))
                    for s in range(25)])
    want = np.array([float(jsched(jnp.int32(s))) for s in range(25)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert got[0] == 0.0 and got[4] == pytest.approx(0.1)
    assert np.all(got[20:] < 1e-9)


def _table(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of tensors or
    ShapeDtypeStructs; ``None`` nodes are skipped, as both checkpoint
    layouts skip them."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_table(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_table(v, f"{prefix}#{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = (tuple(tree.shape),
                            str(tree.dtype).replace("torch.", ""))
    return out


def _all_meta(tree):
    leaves = tree_leaves(tree)
    return bool(leaves) and all(x.is_meta for x in leaves)


@pytest.mark.parametrize("arch", UNCAST_ARCHS)
def test_uncast_struct_matches_reference(arch):
    got = specs.params_struct(configs.get_config(arch), cast=False)
    want = jspecs.params_struct(jconfigs.get_config(arch), cast=False)
    assert _all_meta(got)
    assert _table(got) == _table(want)


def test_cast_params_is_the_struct_policy():
    cfg = dataclasses.replace(
        configs.reduce_for_smoke(configs.get_config("gemma2-2b")),
        dtype="bfloat16")
    concrete = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cast = specs.cast_params(cfg, concrete)
    assert _table(cast) == _table(specs.params_struct(cfg))
    assert {d for _, d in _table(cast).values()} == {"bfloat16", "float32"}
    for a, b in zip(tree_leaves(concrete), tree_leaves(cast)):
        if a.dim() < 2:
            assert b is a
        else:
            assert torch.equal(b, a.to(cfg.activation_dtype))
