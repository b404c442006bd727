"""Port of the moe LM family (``repro_torch.models.lm`` with
``models.moe`` and MLA, ``models.api``, the two configs, ``convert``, the
checkpoint store) against ``repro.models.lm`` at ``reduce_for_smoke`` of
granite-moe-1b-a400m (2 MoE layers of 4 experts, top-2, GQA 4/2 of 32), f32:
the JAX init carried across by ``params_from_jax`` and numpy batches (B 2,
S 40) through both.  ``test_torch_deepseek_lm.py`` runs the same tests on
deepseek-v3-671b's smoke config (1 dense-prefix layer and 1 MoE layer with a
shared expert, MLA, the MTP block) through its own ``smoke`` fixture, in a
file of its own so that each file's JAX compiles stay within 20 s.

Inputs.  The JAX init is changed once, in numpy, before both packages see
it: the stacked experts' matrices are scaled by 0.1 (the reference's init
draws them with a fan-in of E, which makes expert outputs of order 1e3;
scaled, the residual stream stays of order 1).  At S 40 capacity binds:
each arch's forward drops (token, slot) pairs.

Tolerances, as ``test_torch_lm.py``: activations and logits within 1e-5
absolute plus 1e-5 relative; the loss within rtol 1e-5; gradients within
rtol 1e-4 and atol 1e-6; decode against prefill within 5e-4, the
reference's own bound (capacity_factor 8.0 there, so that nothing drops,
as the reference's test sets it).  Each float comparison also shows that a
zero and a sign-flipped result fail it.
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
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import base
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.subset import leaf_paths
from repro_torch.data import synthetic_token_batch
from repro_torch.launch import steps
from repro_torch.models import api, lm, moe
from repro_torch.tree import tree_leaves, tree_map

ATOL = RTOL = 1e-5
SEQ, DECODE = 40, 12
ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")
# the published widths, by the reference's own init shapes: granite whole,
# and deepseek at chip_smoke.py's cut (1 dense-prefix layer, 1 MoE layer of
# 16 experts, the MTP block; every width published)
GRANITE_PARAMS, GRANITE_LEAVES = 1_384_963_072, 13
DEEPSEEK_CUT_PARAMS, DEEPSEEK_LEAVES = 3_706_691_584, 45


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


def _inputs(np_params):
    """The JAX init with the stacked experts scaled by 0.1."""
    p = jax.tree.map(np.array, np_params)
    for k in ("wg", "wu", "wd"):
        p["layers"]["moe"][k] *= 0.1
    return p


def _no_drop(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def make_smoke(arch):
    """The arch's smoke config, params (JAX init, changed as the module
    docstring says) and batch in both packages, and the reference's
    outputs."""
    jcfg = jbase.reduce_for_smoke(jconfigs.get_config(arch))
    cfg = base.reduce_for_smoke(configs.get_config(arch))
    np_params = _inputs(jax.tree.map(np.asarray, jax.jit(
        lambda k: japi.init_params(jcfg, k))(jax.random.PRNGKey(0))))
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = params_from_jax(np_params, device="cpu")
    batch = synthetic_token_batch(1, 2, SEQ, cfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tokens = jbatch["tokens"]

    def oracle_fn(p):
        loss, g = jax.value_and_grad(lambda q: japi.loss_fn(jcfg, q,
                                                            jbatch))(p)
        h, aux = jlm.lm_hidden(jcfg, p, tokens)
        out = {"loss": loss, "grad": g, "hidden": h, "aux": aux,
               "logits": jlm.lm_logits(jcfg, p, tokens)[0],
               "prefill": japi.prefill_logits(jcfg, p, jbatch)}
        if jcfg.use_mtp:
            labels = jnp.maximum(jbatch["labels"], 0)
            mask = (jbatch["labels"] >= 0).astype(jnp.float32)
            out["mtp"] = jlm._mtp_loss(jcfg, p, h, tokens, labels, mask)
        return out
    oracle = jax.tree.map(np.asarray, jax.jit(oracle_fn)(jparams))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams,
                np_params=np_params, params=params, batch=batch,
                tbatch=tbatch, oracle=oracle)


@pytest.fixture(scope="module")
def smoke():
    return make_smoke("granite-moe-1b-a400m")


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params == jcfg.n_params
    assert cfg.n_active_params == jcfg.n_active_params
    assert cfg.activation_dtype == torch.bfloat16
    assert dataclasses.asdict(base.reduce_for_smoke(cfg)) == \
        dataclasses.asdict(jbase.reduce_for_smoke(jcfg))


def _shape_count(jcfg):
    shapes = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(shapes)
    return sum(int(np.prod(x.shape)) for x in leaves), len(leaves)


def test_full_width_trees():
    """granite's published width (13 leaves, 1,384,963,072 params,
    478,943,232 active per token by ``n_active_params``) and deepseek's cut of ``chip_smoke.py`` (45 leaves,
    3,706,691,584 params), by the reference's init shapes; and the
    port's layer split of deepseek at full depth (3 prefix layers, 58
    stacked)."""
    granite = jconfigs.get_config("granite-moe-1b-a400m")
    assert _shape_count(granite) == (GRANITE_PARAMS, GRANITE_LEAVES)
    assert configs.get_config("granite-moe-1b-a400m").n_active_params \
        == 478_943_232
    ds = jconfigs.get_config("deepseek-v3-671b")
    cut = dataclasses.replace(ds, n_layers=2, moe=dataclasses.replace(
        ds.moe, n_experts=16, first_k_dense=1))
    assert _shape_count(cut) == (DEEPSEEK_CUT_PARAMS, DEEPSEEK_LEAVES)
    full = configs.get_config("deepseek-v3-671b")
    assert lm.n_scanned_layers(full) == jlm.n_scanned_layers(ds) == 58


def test_param_tree_structure(smoke):
    """``params_from_jax`` carries the tree across unchanged, the dense
    prefix as a list of unstacked layers and the MTP block included, and
    the port's own init has the same paths, shapes and dtypes."""
    cfg, np_params, params = smoke["cfg"], smoke["np_params"], smoke["params"]
    jleaves = jax.tree_util.tree_leaves_with_path(np_params)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)

    def spell(path):
        return "/".join(f"#{k.idx}" if hasattr(k, "idx") else k.key
                        for k in path)
    assert list(leaf_paths(params)) == sorted(spell(p) for p, _ in jleaves)
    for (path, a), t in zip(jleaves, leaves):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), a)
    own = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tree_map(lambda x: (tuple(x.shape), x.dtype), own) == \
        tree_map(lambda x: (tuple(x.shape), x.dtype), params)
    assert params["layers"]["ln1"].shape[0] == lm.n_scanned_layers(cfg)
    if cfg.use_mtp:
        assert isinstance(own["dense_prefix"], list)
        assert len(own["dense_prefix"]) == cfg.moe.first_k_dense == 1
        assert sorted(own["mtp"]) == ["block", "norm", "proj"]
        # the MTP block's FFN is dense of width d_ff, not MoE
        assert tuple(own["mtp"]["block"]["mlp"]["wg"].shape) == \
            (cfg.d_model, cfg.d_ff)
        assert sorted(own["layers"]["attn"]) == sorted(
            ["w_dq", "w_uq", "w_dkv", "w_krope", "w_uk", "w_uv", "wo"])
        assert "shared" in own["layers"]["moe"]
    else:
        assert "dense_prefix" not in own and "mtp" not in own


def test_params_round_trip_through_numpy_and_checkpoints(smoke, tmp_path):
    """The list-valued dense prefix and the MTP block survive the port's
    ``params_to_numpy`` and both packages' checkpoint stores, each
    reading the other's file."""
    params = smoke["params"]
    back = params_from_jax(params_to_numpy(params), device="cpu")
    assert type(back.get("dense_prefix", [])) is list
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    path = str(tmp_path / "port.npz")
    tstore.save_pytree(path, params)
    loaded = jstore.load_pytree(path)
    assert jax.tree.structure(loaded) == jax.tree.structure(
        smoke["np_params"])
    for a, b in zip(jax.tree.leaves(loaded),
                    jax.tree.leaves(smoke["np_params"])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_hidden_logits_and_aux_match_reference(smoke, monkeypatch):
    """hidden, logits and the summed aux loss, which moves the loss by more
    than 10x its tolerance; capacity drops pairs."""
    cfg, params, tbatch = smoke["cfg"], smoke["params"], smoke["tbatch"]
    drops = []
    real = moe.moe_forward

    def counted(cfg, p, x):
        drops.append(moe.dropped_pairs(cfg, p, x))
        return real(cfg, p, x)
    monkeypatch.setattr(moe, "moe_forward", counted)
    h, aux = lm.lm_hidden(cfg, params, tbatch["tokens"])
    monkeypatch.undo()
    assert tuple(h.shape) == (2, SEQ, cfg.d_model)
    _holds(h, smoke["oracle"]["hidden"])
    _holds(aux, smoke["oracle"]["aux"])
    assert float(aux) > 10 * 1e-5 * float(smoke["oracle"]["loss"])
    assert len(drops) == lm.n_scanned_layers(cfg)
    assert sum(int(d) for d in drops) > 0
    logits, _ = lm.lm_logits(cfg, params, tbatch["tokens"])
    _holds(logits, smoke["oracle"]["logits"])


def test_loss_and_gradient_match_reference(smoke):
    """The loss with the aux loss (and deepseek's 0.1 x MTP loss), and its
    gradient by every leaf, the dense prefix and the MTP block included."""
    cfg, params, tbatch = smoke["cfg"], smoke["params"], smoke["tbatch"]
    loss = api.loss_fn(cfg, params, tbatch)
    assert loss.dtype == torch.float32
    _holds(loss, smoke["oracle"]["loss"], atol=0.0, rtol=1e-5)
    g = grad(lambda p: api.loss_fn(cfg, p, tbatch))(params)
    for a, b in zip(tree_leaves(g), jax.tree.leaves(smoke["oracle"]["grad"])):
        _holds(a, b, atol=1e-6, rtol=1e-4)


def test_mtp_loss_matches_reference_and_moves_the_loss(smoke):
    """deepseek's MTP term alone equals the reference's, and a loss
    without it fails the parity check."""
    cfg, params, tbatch = smoke["cfg"], smoke["params"], smoke["tbatch"]
    if not cfg.use_mtp:
        assert "mtp" not in smoke["oracle"]
        return
    h, _ = lm.lm_hidden(cfg, params, tbatch["tokens"])
    labels = torch.clamp(tbatch["labels"], min=0)
    mask = (tbatch["labels"] >= 0).float()
    mtp = lm._mtp_loss(cfg, params, h, tbatch["tokens"], labels, mask)
    _holds(mtp, smoke["oracle"]["mtp"], atol=0.0, rtol=1e-5)
    want = float(smoke["oracle"]["loss"])
    no_mtp = float(api.loss_fn(dataclasses.replace(cfg, use_mtp=False),
                               params, tbatch))
    assert abs(no_mtp + 0.1 * float(mtp) - want) <= 1e-5 * abs(want)
    assert abs(no_mtp - want) > 10 * 1e-5 * abs(want)


def test_prefill_logits_match_reference(smoke):
    cfg = smoke["cfg"]
    got = steps.make_prefill_step(cfg)(smoke["params"], smoke["tbatch"])
    assert tuple(got.shape) == (2, cfg.vocab)
    _holds(got, smoke["oracle"]["prefill"])


def test_attention_path_by_arch(smoke, monkeypatch):
    """granite's GQA layers go through ``attention.flash_attention`` (the
    kernel on the card), deepseek's MLA layers never do."""
    cfg = smoke["cfg"]
    calls = []
    flash = lm.attn.flash_attention

    def counting(q, k, v, *, causal=True, window=0, cap=0.0):
        assert causal, "a decoder layer ran non-causal attention"
        calls.append(window)
        return flash(q, k, v, causal=causal, window=window, cap=cap)
    monkeypatch.setattr(lm.attn, "flash_attention", counting)
    api.prefill_logits(cfg, smoke["params"], smoke["tbatch"])
    assert calls == ([] if cfg.mla is not None else [0, 0])


def test_decode_steps_match_reference(smoke):
    """DECODE decode steps from an empty cache (GQA k/v or MLA's latent
    ckv/krope, the dense prefix's own): logits at every step and the whole
    cache after the last."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    tokens = smoke["batch"]["tokens"]
    jcache = japi.init_cache(jcfg, smoke["jparams"],
                             {"tokens": jnp.asarray(tokens[:, :1])}, DECODE,
                             jnp.float32)
    jstep = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t,
                                                          pos))
    cache = api.init_cache(cfg, smoke["params"],
                           {"tokens": torch.from_numpy(tokens[:, :1])},
                           DECODE, torch.float32)
    assert tree_map(lambda x: tuple(x.shape), cache) == \
        jax.tree.map(lambda x: tuple(x.shape), jcache)
    step = steps.make_serve_step(cfg)
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


def test_prefill_and_decode_compute_the_same_model(smoke):
    """With capacity_factor 8.0 (nothing drops), decoding DECODE tokens one
    at a time gives prefill's logits at every position, within 5e-4."""
    cfg, params = _no_drop(smoke["cfg"]), smoke["params"]
    tokens = torch.from_numpy(smoke["batch"]["tokens"][:, :DECODE])
    full, _ = lm.lm_logits(cfg, params, tokens)
    cache = api.init_cache(cfg, params, {"tokens": tokens[:, :1]}, DECODE,
                           torch.float32)
    outs = []
    for pos in range(DECODE):
        logits, cache = api.decode_step(cfg, params, cache,
                                        tokens[:, pos:pos + 1], pos)
        outs.append(logits[:, 0])
    _holds(torch.stack(outs, dim=1), full, atol=5e-4, rtol=5e-4)


def test_reference_checkpoint_loads_with_equal_logits(smoke, tmp_path):
    """A checkpoint written by ``repro.checkpoint`` (deepseek's with
    ``dense_prefix/#0/...`` keys) loads in the port, and its prefill logits
    equal those of the params carried across."""
    path = str(tmp_path / "lm.npz")
    jstore.save_pytree(path, smoke["np_params"])
    loaded = tstore.load_pytree(path)
    params = params_from_jax(loaded, device="cpu")
    paths = list(leaf_paths(params))
    assert paths == list(leaf_paths(smoke["params"]))
    assert any(p.startswith("dense_prefix/#0/") for p in paths) == \
        smoke["cfg"].use_mtp
    got = api.prefill_logits(smoke["cfg"], params, smoke["tbatch"])
    want = api.prefill_logits(smoke["cfg"], smoke["params"], smoke["tbatch"])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    _holds(got, smoke["oracle"]["prefill"])
