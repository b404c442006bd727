"""Port of the SSM language model (``repro_torch.models.{mamba2,ssm_lm,api}``,
``repro_torch.configs``, ``synthetic_token_batch``) against the JAX package
at ``reduce_for_smoke(mamba2-130m)`` (2 layers, d 256, vocab 512, state 16,
chunk 16, f32): the JAX init carried across by ``params_from_jax`` and numpy
token streams through both.

Tolerances: the loss within rtol 1e-5; gradients within rtol 1e-4 and atol
1e-6; activations and logits (order 1) within 1e-5 absolute plus 1e-5
relative -- f32 matrix products and the chunked scan sum in other orders.
Each float comparison also shows that a zero and a sign-flipped result fail
it.  On the CPU both packages run the chunked scan (the reference hard-codes
it; the port picks it for CPU tensors), and ``use_kernel=True`` runs both
packages' sequential oracle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.data import synthetic_token_batch as j_tokens
from repro.models import api as japi
from repro.models import mamba2 as jm2
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.core.subset import leaf_paths
from repro_torch.data import synthetic_token_batch
from repro_torch.kernels.ssd import kernel as K
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models import mamba2 as m2
from repro_torch.models import ssm_lm
from repro_torch.tree import tree_leaves, tree_map

ATOL = RTOL = 1e-5
SEQ = 32


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
    """The smoke config in both packages, the JAX init as numpy, the port's
    copy of it, and one token batch; the JAX oracles are computed once."""
    jcfg = jbase.reduce_for_smoke(jconfigs.get_config("mamba2-130m"))
    cfg = base.reduce_for_smoke(configs.get_config("mamba2-130m"))
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_params, device="cpu")
    batch = synthetic_token_batch(1, 2, SEQ, cfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    oracle = {
        "loss": np.asarray(japi.loss_fn(jcfg, jparams, jbatch)),
        "grad": jax.tree.map(np.asarray, jax.grad(
            lambda p: japi.loss_fn(jcfg, p, jbatch))(jparams)),
        "prefill": np.asarray(japi.prefill_logits(jcfg, jparams, jbatch)),
    }
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_params=np_params,
                params=params, batch=batch, jbatch=jbatch, tbatch=tbatch,
                oracle=oracle)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

def _port_config(jcfg):
    """A JAX ArchConfig rebuilt field for field as the port's."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        sub = {"moe": base.MoEConfig, "mla": base.MLAConfig,
               "ssm": base.SSMConfig}.get(f.name)
        kw[f.name] = sub(**dataclasses.asdict(v)) if sub and v else v
    return base.ArchConfig(**kw)


def test_config_registry():
    """Both packages list the same archs, every config the reference's
    (whisper-large-v3's, the encdec arch, among them)."""
    assert configs.list_archs() == [
        "codeqwen1.5-7b", "deepseek-v3-671b", "gemma2-2b",
        "granite-moe-1b-a400m", "internvl2-76b", "mamba2-130m",
        "minitron-8b", "qwen1.5-110b", "whisper-large-v3", "zamba2-1.2b"]
    assert configs.list_archs() == sorted(jconfigs.list_archs())
    for arch in configs.list_archs():
        cfg = configs.get_config(arch)
        jcfg = jconfigs.get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.activation_dtype == torch.bfloat16
        assert base.reduce_for_smoke(cfg).activation_dtype == torch.float32
    whisper = configs.get_config("whisper-large-v3")
    assert dataclasses.asdict(whisper) == dataclasses.asdict(
        jconfigs.get_config("whisper-large-v3"))
    assert whisper.is_encdec and (whisper.enc_layers, whisper.enc_len) == \
        (32, 1500)
    with pytest.raises(KeyError):
        configs.get_config("mamba2-13om")
    assert [dataclasses.asdict(s) for s in base.INPUT_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.INPUT_SHAPES]
    assert base.get_shape("prefill_32k").seq_len == 32_768


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_n_params_and_smoke_reduction_match_reference(arch):
    """``n_params``/``n_active_params`` and ``reduce_for_smoke`` on every
    reference architecture, rebuilt as the port's dataclass."""
    jcfg = jconfigs.get_config(arch)
    cfg = _port_config(jcfg)
    assert cfg.n_params == jcfg.n_params
    assert cfg.n_active_params == jcfg.n_active_params
    assert dataclasses.asdict(base.reduce_for_smoke(cfg)) == \
        dataclasses.asdict(jbase.reduce_for_smoke(jcfg))


def test_synthetic_token_batch_is_bit_equal():
    for seed, b, s, v in ((0, 1, 16, 512), (3, 4, 33, 50280), (7, 2, 1, 5)):
        got, want = synthetic_token_batch(seed, b, s, v), j_tokens(seed, b,
                                                                   s, v)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def test_param_tree_structure_and_count(smoke):
    """``params_from_jax`` carries the stacked-layer tree across unchanged
    (12 leaves, same paths, shapes and dtypes), and the port's own init has
    the same structure."""
    cfg, np_params, params = smoke["cfg"], smoke["np_params"], smoke["params"]
    jleaves = jax.tree_util.tree_leaves_with_path(np_params)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves) == 12
    assert list(leaf_paths(params)) == sorted(
        "/".join(k.key for k in path) for path, _ in jleaves)
    for (path, a), t in zip(jleaves, leaves):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
        np.testing.assert_array_equal(t.numpy(), a)
    assert params["layers"]["mamba"]["in_proj"].shape[0] == cfg.n_layers
    own = ssm_lm.init_ssm_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tree_map(lambda x: (tuple(x.shape), x.dtype), own) == \
        tree_map(lambda x: (tuple(x.shape), x.dtype), params)
    assert sum(x.numel() for x in tree_leaves(own)) == \
        sum(a.size for a in jax.tree.leaves(np_params))
    full = configs.get_config("mamba2-130m")
    # the full width's count, from the shapes alone (no allocation)
    d, L = full.d_model, full.n_layers
    d_in, nh, conv = m2.dims(full)
    per = (d * (2 * d_in + 2 * full.ssm.state_dim + nh) + 4 * conv + conv
           + 3 * nh + d_in + d_in * d + d)
    assert 2 * full.vocab * d + d + L * per == 167_598_528


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_forward_matches_reference(smoke, use_kernel):
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    lp_np = jax.tree.map(lambda a: a[1], smoke["np_params"]["layers"])
    x = np.random.RandomState(2).randn(2, SEQ, cfg.d_model).astype(
        np.float32)
    want = jm2.mamba2_forward(jcfg, jax.tree.map(jnp.asarray,
                                                 lp_np["mamba"]),
                              jnp.asarray(x), use_kernel=use_kernel)
    lp = params_from_jax(lp_np, device="cpu")
    K.reset_launches()
    got = m2.mamba2_forward(cfg, lp["mamba"], torch.from_numpy(x),
                            use_kernel=use_kernel)
    assert K.LAUNCHES["ssd_fwd"] == 0          # CPU: the plain version
    _holds(got, want)


def test_ssm_lm_loss_and_gradient_match_reference(smoke):
    cfg, params, tbatch = smoke["cfg"], smoke["params"], smoke["tbatch"]
    oracle = smoke["oracle"]
    loss = ssm_lm.ssm_lm_loss(cfg, params, tbatch)
    assert loss.dtype == torch.float32
    _holds(loss, oracle["loss"], atol=0.0, rtol=1e-5)
    assert float(api.loss_fn(cfg, params, tbatch)) == float(loss)
    g = grad(lambda p: api.loss_fn(cfg, p, tbatch))(params)
    for a, b in zip(tree_leaves(g), jax.tree.leaves(oracle["grad"])):
        if not np.abs(b).max():
            # gradients that are 0 in the reference (none expected)
            np.testing.assert_array_equal(a.numpy(), b)
            continue
        _holds(a, b, atol=1e-6, rtol=1e-4)
    # labels < 0 are masked out of the mean, as in the reference
    masked = dict(smoke["batch"], labels=smoke["batch"]["labels"].copy())
    masked["labels"][:, ::3] = -1
    want = japi.loss_fn(smoke["jcfg"], smoke["jparams"],
                        {k: jnp.asarray(v) for k, v in masked.items()})
    got = api.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                    for k, v in masked.items()})
    _holds(got, want, atol=0.0, rtol=1e-5)


def test_prefill_logits_match_reference(smoke):
    cfg, params = smoke["cfg"], smoke["params"]
    got = steps.make_prefill_step(cfg)(params, smoke["tbatch"])
    assert tuple(got.shape) == (2, cfg.vocab)
    _holds(got, smoke["oracle"]["prefill"])


def test_decode_steps_match_reference(smoke):
    """Four decode steps from an empty cache: logits and the cache (conv
    ring buffer and SSM state) after each."""
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    tokens = smoke["batch"]["tokens"]
    jcache = japi.init_cache(jcfg, smoke["jparams"],
                             {"tokens": jnp.asarray(tokens[:, :1])}, 8,
                             jnp.float32)
    cache = api.init_cache(cfg, smoke["params"],
                           {"tokens": torch.from_numpy(tokens[:, :1])}, 8,
                           torch.float32)
    assert tree_map(lambda x: tuple(x.shape), cache) == \
        jax.tree.map(lambda x: tuple(x.shape), jcache)
    step = steps.make_serve_step(cfg)
    jstep = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t,
                                                          pos))
    for pos in range(4):
        tok = tokens[:, pos:pos + 1]
        jl, jcache = jstep(smoke["jparams"], jcache, jnp.asarray(tok),
                           jnp.int32(pos))
        logits, cache = step(smoke["params"], cache, torch.from_numpy(tok),
                             pos)
        assert tuple(logits.shape) == (2, 1, cfg.vocab)
        _holds(logits, jl)
        for a, b in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
            if pos == 0 and a.dim() == 5:
                # the first step's conv ring still holds zeros in every
                # slot but the newest: compare it exactly
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=ATOL, rtol=RTOL)
                continue
            _holds(a, b)
    # the decode recurrence and the chunked scan compute the same model:
    # decoding the first chunk (16 tokens) ends at prefill's logits
    for pos in range(4, 16):
        logits, cache = step(smoke["params"], cache,
                             torch.from_numpy(tokens[:, pos:pos + 1]), pos)
    pre = api.prefill_logits(cfg, smoke["params"],
                             {"tokens": torch.from_numpy(tokens[:, :16])})
    _holds(logits[:, 0], pre, atol=1e-4, rtol=1e-4)


def test_hybrid_and_other_families_raise():
    """The hybrid family is ported (it builds the shared block), and so are
    the dense, vlm and moe families (``models/lm.py``; a moe config's loss
    equals the reference's) and the audio family (``models/encdec.py``: an
    encdec config builds the reference's tree, and its loss from the
    reference's init equals the reference's)."""
    cfg = base.reduce_for_smoke(configs.get_config("mamba2-130m"))
    hybrid = dataclasses.replace(cfg, family="hybrid", attn_every=2,
                                 n_heads=4, n_kv_heads=4, head_dim=32,
                                 d_ff=512)
    params = api.init_params(hybrid, torch.Generator().manual_seed(0), "cpu")
    assert sorted(params["shared"]) == ["attn", "ln_in", "ln_mlp", "mlp"]
    dense = dataclasses.replace(hybrid, family="dense", ssm=None,
                                attn_every=0)
    params = api.init_params(dense, torch.Generator().manual_seed(0), "cpu")
    assert sorted(params) == ["embed", "final_norm", "layers"]
    assert sorted(params["layers"]) == ["attn", "ln1", "ln2", "mlp"]
    vlm = dataclasses.replace(dense, family="vlm", n_visual_tokens=4)
    params = api.init_params(vlm, torch.Generator().manual_seed(0), "cpu")
    assert tuple(params["vis_proj"].shape) == (vlm.d_model, vlm.d_model)
    # the moe family goes to models/lm.py: its loss, with the router's aux
    # loss, from the reference's init equals the reference's
    moe = dataclasses.replace(dense, family="moe", moe=base.MoEConfig(
        n_experts=4, top_k=2, expert_d_ff=64))
    params = api.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    assert sorted(params["layers"]) == ["attn", "ln1", "ln2", "moe"]
    kw = dataclasses.asdict(moe)
    kw["moe"] = jbase.MoEConfig(**kw["moe"])
    jmoe = jbase.ArchConfig(**kw)
    np_params = jax.tree.map(np.asarray, jax.jit(
        lambda k: japi.init_params(jmoe, k))(jax.random.PRNGKey(0)))
    batch = synthetic_token_batch(2, 2, 24, moe.vocab)
    want = jax.jit(lambda p: japi.loss_fn(jmoe, p, batch))(np_params)
    got = api.loss_fn(moe, params_from_jax(np_params, device="cpu"),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    _holds(got, want, atol=0.0, rtol=1e-5)
    audio = dataclasses.replace(dense, family="audio", is_encdec=True,
                                enc_layers=1, enc_len=12)
    params = api.init_params(audio, torch.Generator().manual_seed(0), "cpu")
    assert sorted(params) == ["dec_layers", "embed", "enc_layers",
                              "enc_norm", "final_norm"]
    assert sorted(params["dec_layers"]) == ["cross", "ln1", "ln2", "ln_x",
                                            "mlp", "self"]
    jaudio = jbase.ArchConfig(**dataclasses.asdict(audio))
    np_params = jax.tree.map(np.asarray, jax.jit(
        lambda k: japi.init_params(jaudio, k))(jax.random.PRNGKey(0)))
    assert leaf_paths(params) == leaf_paths(
        params_from_jax(np_params, device="cpu"))
    batch["frames"] = np.random.RandomState(4).randn(
        2, audio.enc_len, audio.d_model).astype(np.float32)
    want = jax.jit(lambda p: japi.loss_fn(jaudio, p, batch))(np_params)
    got = api.loss_fn(audio, params_from_jax(np_params, device="cpu"),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    _holds(got, want, atol=0.0, rtol=1e-5)
