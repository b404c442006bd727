"""Port of the dense and vlm decoder LM (``repro_torch.models.lm``,
``models.api``, the five configs, ``convert``, the checkpoint store) against
``repro.models.lm`` at ``reduce_for_smoke`` of gemma2-2b, codeqwen1.5-7b,
minitron-8b, qwen1.5-110b and internvl2-76b (2 layers, d 256, 4 heads of 32,
d_ff 1024, vocab 512, f32; gemma2's window 16, layer 0 local and layer 1
global; internvl2's 8 visual tokens): the JAX init carried across by
``params_from_jax`` and numpy batches (B 2, S 40) through both.

Inputs.  Each arch's JAX init is changed once, in numpy, before both
packages see it: the qwen-family QKV biases (zero at init) are drawn
non-zero; gemma2's ``wq`` and ``wk`` are scaled by 4 (attention logits of
std ~16, so the softcap of 50 binds) and its ``unembed`` by 4 (final logits
of std ~4, so the softcap of 30 binds); internvl2's ``visual`` prefix is a
unit normal.  ``test_gemma2_feature_moves_the_logits`` shows that each of
gemma2's features -- local/global alternation, the embedding scale, the
post-block norms, the two softcaps -- moves the logits by at least 10x the
tolerance, and that a port without it fails the parity check.

Tolerances, as ``test_torch_hybrid_lm.py``: activations and logits within
1e-5 absolute plus 1e-5 relative; the loss within rtol 1e-5; gradients
within rtol 1e-4 and atol 1e-6.  Each float comparison also shows that a
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
from repro_torch.convert import params_from_jax
from repro_torch.core.subset import leaf_paths
from repro_torch.data import synthetic_token_batch
from repro_torch.launch import steps
from repro_torch.models import api, attention, lm
from repro_torch.tree import tree_leaves, tree_map

ATOL = RTOL = 1e-5
SEQ, DECODE = 40, 22            # 22 decode steps: 6 past gemma2's window
ARCHS = ("gemma2-2b", "codeqwen1.5-7b", "minitron-8b", "qwen1.5-110b",
         "internvl2-76b")
# gemma2-2b at its published width, by the reference's own init shapes
GEMMA2_PARAMS, GEMMA2_LEAVES = 3_204_165_888, 14


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


def _inputs(np_params, cfg):
    """The arch's JAX init changed as the module docstring says."""
    rs = np.random.RandomState(7)
    p = jax.tree.map(np.array, np_params)
    a = p["layers"]["attn"]
    if cfg.qkv_bias:
        for k in ("bq", "bk", "bv"):
            a[k] = (0.5 * rs.randn(*a[k].shape)).astype(np.float32)
    if cfg.attn_softcap:
        a["wq"] *= 4.0
        a["wk"] *= 4.0
    if cfg.final_softcap:
        p["embed"]["unembed"] *= 4.0
    return p


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    arch = request.param
    jcfg = jbase.reduce_for_smoke(jconfigs.get_config(arch))
    cfg = base.reduce_for_smoke(configs.get_config(arch))
    np_params = _inputs(jax.tree.map(np.asarray, japi.init_params(
        jcfg, jax.random.PRNGKey(0))), cfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = params_from_jax(np_params, device="cpu")
    batch = synthetic_token_batch(1, 2, SEQ, cfg.vocab)
    if cfg.n_visual_tokens:
        batch["visual"] = np.random.RandomState(3).randn(
            2, cfg.n_visual_tokens, cfg.d_model).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def oracle_fn(p):
        loss, g = jax.value_and_grad(lambda q: japi.loss_fn(jcfg, q,
                                                            jbatch))(p)
        tokens, visual = jbatch["tokens"], jbatch.get("visual")
        h, aux = jlm.lm_hidden(jcfg, p, tokens, visual)
        return {"loss": loss, "grad": g, "hidden": h, "aux": aux,
                "logits": jlm.lm_logits(jcfg, p, tokens, visual)[0],
                "prefill": japi.prefill_logits(jcfg, p, jbatch)}
    oracle = jax.tree.map(np.asarray, jax.jit(oracle_fn)(jparams))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams,
                np_params=np_params, params=params, batch=batch,
                tbatch=tbatch, oracle=oracle)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params == jcfg.n_params
    assert cfg.activation_dtype == torch.bfloat16
    assert dataclasses.asdict(base.reduce_for_smoke(cfg)) == \
        dataclasses.asdict(jbase.reduce_for_smoke(jcfg))


def test_gemma2_full_width_tree():
    """gemma2-2b's published width: the reference's init shapes (14 leaves,
    3,204,165,888 params; ``n_params`` gives 3,203,923,968) and its
    alternation (even layers local)."""
    full = configs.get_config("gemma2-2b")
    assert full.n_params == 3_203_923_968
    shapes = jax.eval_shape(lambda k: japi.init_params(
        jconfigs.get_config("gemma2-2b"), k), jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(shapes)
    assert len(leaves) == GEMMA2_LEAVES
    assert sum(int(np.prod(x.shape)) for x in leaves) == GEMMA2_PARAMS
    assert [lm._window(full, i) for i in range(4)] == [4096, 0, 4096, 0]
    want = np.asarray(jlm._is_local_flags(full, full.n_layers))
    assert [lm._is_local(full, i) for i in range(full.n_layers)] == \
        want.tolist()


def test_param_tree_structure(smoke):
    """``params_from_jax`` carries the stacked-layer tree across unchanged,
    and the port's own init has the same paths, shapes and dtypes."""
    cfg, np_params, params = smoke["cfg"], smoke["np_params"], smoke["params"]
    jleaves = jax.tree_util.tree_leaves_with_path(np_params)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    assert list(leaf_paths(params)) == sorted(
        "/".join(k.key for k in path) for path, _ in jleaves)
    for (path, a), t in zip(jleaves, leaves):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), a)
    assert params["layers"]["ln1"].shape[0] == cfg.n_layers
    own = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tree_map(lambda x: (tuple(x.shape), x.dtype), own) == \
        tree_map(lambda x: (tuple(x.shape), x.dtype), params)
    assert ("vis_proj" in own) == bool(cfg.n_visual_tokens)
    assert ("ln1_post" in own["layers"]) == cfg.post_block_norm
    assert ("bq" in own["layers"]["attn"]) == cfg.qkv_bias


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_hidden_and_logits_match_reference(smoke):
    cfg, params, tbatch = smoke["cfg"], smoke["params"], smoke["tbatch"]
    h, aux = lm.lm_hidden(cfg, params, tbatch["tokens"],
                          tbatch.get("visual"))
    assert tuple(h.shape) == (2, cfg.n_visual_tokens + SEQ, cfg.d_model)
    _holds(h, smoke["oracle"]["hidden"])
    assert float(aux) == float(smoke["oracle"]["aux"]) == 0.0
    logits, _ = lm.lm_logits(cfg, params, tbatch["tokens"],
                             tbatch.get("visual"))
    _holds(logits, smoke["oracle"]["logits"])


def test_loss_and_gradient_match_reference(smoke):
    cfg, params, tbatch = smoke["cfg"], smoke["params"], smoke["tbatch"]
    loss = api.loss_fn(cfg, params, tbatch)
    assert loss.dtype == torch.float32
    _holds(loss, smoke["oracle"]["loss"], atol=0.0, rtol=1e-5)
    g = grad(lambda p: api.loss_fn(cfg, p, tbatch))(params)
    for a, b in zip(tree_leaves(g), jax.tree.leaves(smoke["oracle"]["grad"])):
        _holds(a, b, atol=1e-6, rtol=1e-4)


def test_prefill_logits_match_reference(smoke):
    cfg = smoke["cfg"]
    got = steps.make_prefill_step(cfg)(smoke["params"], smoke["tbatch"])
    assert tuple(got.shape) == (2, cfg.vocab)
    _holds(got, smoke["oracle"]["prefill"])


def test_every_layer_runs_flash_attention(smoke, monkeypatch):
    """The full-sequence path sends every layer through
    ``attention.flash_attention`` (the kernel on the card) with its static
    window, never the plain ``sdpa``."""
    cfg = smoke["cfg"]
    windows = []
    flash = attention.flash_attention

    def counting(q, k, v, *, causal=True, window=0, cap=0.0):
        assert causal, "a decoder layer ran non-causal attention"
        windows.append(window)
        return flash(q, k, v, causal=causal, window=window, cap=cap)

    def refuse(*a, **kw):
        raise AssertionError("the full-sequence path ran the plain sdpa")

    monkeypatch.setattr(attention, "flash_attention", counting)
    monkeypatch.setattr(attention, "sdpa", refuse)
    api.prefill_logits(cfg, smoke["params"], smoke["tbatch"])
    want = [16, 0] if cfg.local_global_period else [0, 0]
    assert windows == want


def _jax_decode(smoke, tokens, max_len):
    jcfg = smoke["jcfg"]
    jcache = japi.init_cache(jcfg, smoke["jparams"],
                             {"tokens": jnp.asarray(tokens[:, :1])}, max_len,
                             jnp.float32)
    jstep = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t,
                                                          pos))
    out = []
    for pos in range(DECODE):
        jl, jcache = jstep(smoke["jparams"], jcache,
                           jnp.asarray(tokens[:, pos:pos + 1]),
                           jnp.int32(pos))
        out.append(np.asarray(jl))
    return out, jcache


def test_decode_steps_past_the_window_match_reference(smoke):
    """22 decode steps from an empty cache (max_len 24): for gemma2 the last
    6 attend past its local layer's window of 16.  Logits at every step and
    the whole cache after the last."""
    cfg = smoke["cfg"]
    tokens = smoke["batch"]["tokens"]
    want, jcache = _jax_decode(smoke, tokens, DECODE + 2)
    cache = api.init_cache(cfg, smoke["params"],
                           {"tokens": torch.from_numpy(tokens[:, :1])},
                           DECODE + 2, torch.float32)
    assert tree_map(lambda x: tuple(x.shape), cache) == \
        jax.tree.map(lambda x: tuple(x.shape), jcache)
    step = steps.make_serve_step(cfg)
    for pos in range(DECODE):
        logits, cache = step(smoke["params"], cache,
                             torch.from_numpy(tokens[:, pos:pos + 1]), pos)
        assert tuple(logits.shape) == (2, 1, cfg.vocab)
        _holds(logits, want[pos])
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        _holds(a, b)


def test_prefill_and_decode_compute_the_same_model(smoke):
    """Decoding 22 tokens one at a time ends at prefill's logits of those 22
    tokens (the vlm arch without its visual prefix, which decode does not
    see, as in the reference)."""
    cfg, params = smoke["cfg"], smoke["params"]
    tokens = torch.from_numpy(smoke["batch"]["tokens"][:, :DECODE])
    cache = api.init_cache(cfg, params, {"tokens": tokens[:, :1]}, DECODE,
                           torch.float32)
    for pos in range(DECODE):
        logits, cache = api.decode_step(cfg, params, cache,
                                        tokens[:, pos:pos + 1], pos)
    text = dataclasses.replace(cfg, n_visual_tokens=0)
    pre = api.prefill_logits(text, params, {"tokens": tokens})
    _holds(logits[:, 0], pre, atol=1e-4, rtol=1e-4)


def test_reference_checkpoint_loads_with_equal_logits(smoke, tmp_path):
    """A checkpoint written by ``repro.checkpoint`` loads in the port, and
    its prefill logits equal those of the params carried across."""
    path = str(tmp_path / "lm.npz")
    jstore.save_pytree(path, smoke["np_params"])
    loaded = tstore.load_pytree(path)
    params = params_from_jax(loaded, device="cpu")
    assert list(leaf_paths(params)) == list(leaf_paths(smoke["params"]))
    got = api.prefill_logits(smoke["cfg"], params, smoke["tbatch"])
    want = api.prefill_logits(smoke["cfg"], smoke["params"], smoke["tbatch"])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    _holds(got, smoke["oracle"]["prefill"])


# ---------------------------------------------------------------------------
# gemma2's features, each held by the parity check
# ---------------------------------------------------------------------------

def _no_embed_scale(cfg, params, tokens):
    return lm.embed_tokens(params["embed"], tokens, cfg.activation_dtype)


def _no_post_norm(cfg, p, key, x):
    return x


# feature -> (config change, module patch): the mutant computes the model
# without that feature
MUTANTS = {
    "all layers local": (dict(local_global_period=0), None),
    "all layers global": (dict(sliding_window=0), None),
    "no embedding scale": ({}, ("_embed", _no_embed_scale)),
    "no post-block norms": ({}, ("_post_block", _no_post_norm)),
    "no attention softcap": (dict(attn_softcap=0.0), None),
    "no final softcap": (dict(final_softcap=0.0), None),
}


@pytest.fixture(scope="module")
def gemma2():
    """gemma2's smoke inputs and the reference's logits of all positions."""
    jcfg = jbase.reduce_for_smoke(jconfigs.get_config("gemma2-2b"))
    cfg = base.reduce_for_smoke(configs.get_config("gemma2-2b"))
    np_params = _inputs(jax.tree.map(np.asarray, japi.init_params(
        jcfg, jax.random.PRNGKey(0))), cfg)
    tokens = synthetic_token_batch(1, 2, SEQ, cfg.vocab)["tokens"]
    want, _ = jax.jit(lambda p: jlm.lm_logits(jcfg, p, jnp.asarray(tokens)))(
        jax.tree.map(jnp.asarray, np_params))
    return dict(cfg=cfg, params=params_from_jax(np_params, device="cpu"),
                tokens=torch.from_numpy(tokens), want=np.asarray(want))


@pytest.mark.parametrize("feature", sorted(MUTANTS))
def test_gemma2_feature_moves_the_logits(gemma2, feature, monkeypatch):
    """A port without the feature moves some logit by at least 10x the
    tolerance, and fails the parity check the port passes."""
    cfg, params, tokens, want = (gemma2[k] for k in ("cfg", "params",
                                                     "tokens", "want"))
    _holds(lm.lm_logits(cfg, params, tokens)[0], want)
    change, patch = MUTANTS[feature]
    if patch is not None:
        monkeypatch.setattr(lm, *patch)
    got = lm.lm_logits(dataclasses.replace(cfg, **change), params,
                       tokens)[0].numpy()
    moved = np.abs(got - want) / (ATOL + RTOL * np.abs(want))
    assert moved.max() >= 10.0, (feature, moved.max())
    with pytest.raises(AssertionError):
        _holds(got, want)


# ---------------------------------------------------------------------------
# the moe family's branches on gemma2's smoke config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", ["moe", "mla", "use_mtp"])
def test_moe_branches_raise_naming_the_moe_slice(change):
    """The branches the dense slice refused -- a MoE FFN, MLA, the MTP loss
    -- each added to gemma2's smoke config (post-block norms, softcaps,
    alternation kept): the port's init has the reference's tree, and from
    the reference's init its logits and its loss (with the aux loss, or
    0.1 x the MTP loss) equal the reference's."""
    cfg = base.reduce_for_smoke(configs.get_config("gemma2-2b"))
    jcfg = jbase.reduce_for_smoke(jconfigs.get_config("gemma2-2b"))
    value, jvalue = {
        "moe": (base.MoEConfig(n_experts=4, top_k=2, expert_d_ff=64),
                jbase.MoEConfig(n_experts=4, top_k=2, expert_d_ff=64)),
        "mla": (base.MLAConfig(), jbase.MLAConfig()),
        "use_mtp": (True, True)}[change]
    cfg = dataclasses.replace(cfg, **{change: value})
    jcfg = dataclasses.replace(jcfg, **{change: jvalue})
    np_params = jax.tree.map(np.asarray, jax.jit(
        lambda k: japi.init_params(jcfg, k))(jax.random.PRNGKey(0)))
    own = lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tree_map(lambda x: tuple(x.shape), own) == \
        jax.tree.map(lambda x: x.shape, np_params)
    batch = synthetic_token_batch(1, 2, SEQ, cfg.vocab)
    want_logits, want_loss = jax.jit(lambda p: (
        jlm.lm_logits(jcfg, p, batch["tokens"])[0],
        japi.loss_fn(jcfg, p, batch)))(np_params)
    params = params_from_jax(np_params, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _holds(lm.lm_logits(cfg, params, tbatch["tokens"])[0], want_logits)
    _holds(api.loss_fn(cfg, params, tbatch), want_loss, atol=0.0, rtol=1e-5)
