"""Port of the encoder-decoder (``repro_torch.models.encdec``, the GELU MLP
and sinusoidal positions of ``models.layers``, ``models.api``'s encdec
branch, whisper-large-v3's config) against ``repro.models.encdec`` at
``reduce_for_smoke(whisper-large-v3)`` (2 encoder and 2 decoder layers, d
256, 4 heads of 32, d_ff 1024, vocab 512, enc_len 16, f32): the JAX init
carried across by ``params_from_jax`` and numpy batches (B 2, S 24, unit
normal frames) through both.

Tolerances, as ``test_torch_lm.py``: activations and logits within 1e-5
absolute plus 1e-5 relative; the loss within rtol 1e-5; gradients within
rtol 1e-4 and atol 1e-6.  Each float comparison also shows that a zero and
a sign-flipped result fail it, and the model checks that the answer with a
causal encoder (or causal cross-attention) fails it too: the checks see
the non-causal branch.
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
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.core.subset import leaf_paths
from repro_torch.data import synthetic_token_batch
from repro_torch.launch import steps
from repro_torch.models import api, attention
from repro_torch.models import encdec as ed
from repro_torch.models import layers
from repro_torch.tree import tree_leaves, tree_map

ATOL = RTOL = 1e-5
ARCH = "whisper-large-v3"
B, SEQ, DECODE = 2, 24, 10
# whisper-large-v3 at its published width, by the reference's init shapes
WHISPER_PARAMS, WHISPER_LEAVES = 1_600_990_720, 25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _holds(got, want, *wrong, atol=ATOL, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    for bad in (np.zeros_like(want), -want) + wrong:
        assert not np.allclose(np.asarray(bad, np.float32), want, atol=atol,
                               rtol=rtol)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jbase.reduce_for_smoke(jconfigs.get_config(ARCH))
    cfg = base.reduce_for_smoke(configs.get_config(ARCH))
    np_params = jax.tree.map(np.asarray, japi.init_params(
        jcfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    batch = synthetic_token_batch(1, B, SEQ, cfg.vocab)
    batch["frames"] = np.random.RandomState(3).randn(
        B, cfg.enc_len, cfg.d_model).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def oracle_fn(p):
        loss, g = jax.value_and_grad(lambda q: japi.loss_fn(jcfg, q,
                                                            jbatch))(p)
        enc = jed.encode(jcfg, p, jbatch["frames"])
        dec = jed.decode_full(jcfg, p, jbatch["tokens"], enc)
        return {"loss": loss, "grad": g, "enc": enc, "dec": dec,
                "logits": jlayers.unembed(p["embed"], dec,
                                          jcfg.final_softcap),
                "prefill": japi.prefill_logits(jcfg, p, jbatch)}
    oracle = jax.tree.map(np.asarray, jax.jit(oracle_fn)(jparams))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_params=np_params,
                params=params_from_jax(np_params, device="cpu"),
                batch=batch, oracle=oracle,
                tbatch={k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# config, params, layers
# ---------------------------------------------------------------------------

def test_config_and_full_width_tree_match_reference(smoke):
    """whisper-large-v3's config is the reference's; its published width
    has the reference's init tree (25 leaves, 1,600,990,720 params by
    ``jax.eval_shape``), and the port's init has the reference's tree at
    smoke size, on the CPU."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params == jcfg.n_params
    assert cfg.is_encdec and cfg.activation_dtype == torch.bfloat16
    assert dataclasses.asdict(smoke["cfg"]) == dataclasses.asdict(
        smoke["jcfg"])
    shapes = jax.tree.leaves(jax.eval_shape(
        lambda k: japi.init_params(jcfg, k), jax.random.PRNGKey(0)))
    assert (sum(int(np.prod(s.shape)) for s in shapes), len(shapes)) == \
        (WHISPER_PARAMS, WHISPER_LEAVES)
    own = api.init_params(smoke["cfg"], torch.Generator().manual_seed(0),
                          "cpu")
    assert leaf_paths(own) == leaf_paths(smoke["params"])
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), own) == tree_map(
        lambda t: (tuple(t.shape), t.dtype), smoke["params"])
    assert all(x.device.type == "cpu" for x in tree_leaves(own))


@pytest.mark.parametrize("n,d,offset", [(16, 256, 0), (40, 256, 3),
                                        (1, 1280, 447), (1500, 1280, 0)])
def test_sinusoidal_positions_match_reference(n, d, offset):
    """The (n, d) table of positions offset .. offset + n - 1.  XLA's and
    PyTorch's f32 ``pow`` and ``sin`` differ by ulps, which the angles
    (up to 1,500 radians at whisper's enc_len, where an ulp is 1.2e-4)
    carry: within 1e-5 up to 500 radians, 5e-5 at 1,500."""
    got = layers.sinusoidal_positions(n, d, offset)
    want = jlayers.sinusoidal_positions(n, d, offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    atol = 5e-5 if n + offset > 500 else ATOL
    shifted = jlayers.sinusoidal_positions(n, d, offset + 1)
    _holds(got, want, shifted, atol=atol, rtol=0)
    # the host table lands on the requested device unchanged
    assert torch.equal(layers.sinusoidal_positions(n, d, offset, "cpu"), got)


def test_mlp_gelu_forward_matches_reference_and_not_exact_gelu():
    """The tanh form, as ``jax.nn.gelu``'s default; the exact-erf GELU
    (``F.gelu``'s default) differs by more than the tolerance."""
    k = jax.random.PRNGKey(4)
    np_p = jax.tree.map(np.asarray, jlayers.init_mlp_gelu(k, 64, 256))
    x = 2.0 * np.random.RandomState(5).randn(3, 7, 64).astype(np.float32)
    p = params_from_jax(np_p, device="cpu")
    got = layers.mlp_gelu_forward(p, torch.from_numpy(x))
    want = jlayers.mlp_gelu_forward(np_p, jnp.asarray(x))
    xt = torch.from_numpy(x)
    erf = torch.nn.functional.gelu(xt @ p["w1"]) @ p["w2"]
    _holds(got, want, erf)
    g = torch.Generator().manual_seed(0)
    own = layers.init_mlp_gelu(g, 64, 256)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in np_p.items()}


def test_cross_attn_decode_matches_reference(smoke):
    cfg, jcfg = smoke["cfg"], smoke["jcfg"]
    np_p = jax.tree.map(lambda x: x[0], smoke["np_params"]["dec_layers"]
                        ["cross"])
    rs = np.random.RandomState(6)
    hd = cfg.resolved_head_dim
    x = rs.randn(B, 1, cfg.d_model).astype(np.float32)
    ek, ev = (rs.randn(B, 19, cfg.n_kv_heads, hd).astype(np.float32)
              for _ in range(2))
    got = attention.cross_attn_decode(
        cfg, params_from_jax(np_p, device="cpu"), *map(torch.from_numpy,
                                                        (x, ek, ev)))
    want = jattn.cross_attn_decode(jcfg, np_p, *map(jnp.asarray,
                                                    (x, ek, ev)))
    # the cross-attention over the first 10 encoder frames only
    short = jattn.cross_attn_decode(jcfg, np_p, jnp.asarray(x),
                                    jnp.asarray(ek[:, :10]),
                                    jnp.asarray(ev[:, :10]))
    _holds(got, want, short)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _causal_encoder(monkeypatch):
    """A port whose encoder and cross-attention are causal: every
    ``causal=False`` call of ``FlashAttention`` turned into a causal one."""
    real = attention.flash_attention

    def causal(q, k, v, *, causal=True, window=0, cap=0.0):
        return real(q, k, v, causal=True, window=window, cap=cap)
    monkeypatch.setattr(attention, "flash_attention", causal)


def test_encode_and_decode_full_match_reference(smoke, monkeypatch):
    """The encoder's hidden states and the teacher-forced decoder's, every
    full-sequence attention through ``FlashAttention`` (2 bidirectional
    encoder layers, 2 causal self and 2 cross decoder layers) and none
    through ``sdpa``; a causal encoder and causal cross-attention give
    other numbers."""
    cfg, params, tb, o = (smoke["cfg"], smoke["params"], smoke["tbatch"],
                          smoke["oracle"])
    calls = []
    real = attention.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal", True)))
        return real(q, k, v, **kw)

    def no_sdpa(*a, **kw):
        raise AssertionError("full-sequence attention ran the plain sdpa")
    with monkeypatch.context() as m:
        m.setattr(attention, "flash_attention", counting)
        m.setattr(attention, "sdpa", no_sdpa)
        enc = ed.encode(cfg, params, tb["frames"])
        dec = ed.decode_full(cfg, params, tb["tokens"], enc)
    T = cfg.enc_len
    assert calls == [(T, T, False)] * 2 + [(SEQ, SEQ, True),
                                           (SEQ, T, False)] * 2
    with monkeypatch.context() as m:
        _causal_encoder(m)
        enc_c = ed.encode(cfg, params, tb["frames"])
        dec_c = ed.decode_full(cfg, params, tb["tokens"], enc)
    assert enc.dtype == dec.dtype == torch.float32
    _holds(enc, o["enc"], enc_c)
    _holds(dec, o["dec"], dec_c)


def test_loss_and_gradient_match_reference(smoke):
    cfg, o = smoke["cfg"], smoke["oracle"]
    loss = api.loss_fn(cfg, smoke["params"], smoke["tbatch"])
    _holds(loss, o["loss"], atol=0.0, rtol=RTOL)
    g = grad(lambda p: api.loss_fn(cfg, p, smoke["tbatch"]))(smoke["params"])
    assert leaf_paths(g) == leaf_paths(smoke["params"])
    for a, b in zip(tree_leaves(g), jax.tree.leaves(o["grad"])):
        if not np.any(b):
            np.testing.assert_array_equal(a.numpy(), b)
            continue
        _holds(a, b, atol=1e-6, rtol=1e-4)
    # the gradient reaches the encoder through the cross-attention
    assert float(g["enc_layers"]["attn"]["wq"].abs().max()) > 1e-3


def test_prefill_logits_match_reference(smoke):
    cfg, o = smoke["cfg"], smoke["oracle"]
    pre = api.prefill_logits(cfg, smoke["params"], smoke["tbatch"])
    assert tuple(pre.shape) == (B, cfg.vocab)
    step = steps.make_prefill_step(cfg)
    assert torch.equal(step(smoke["params"], smoke["tbatch"]), pre)
    _holds(pre, o["prefill"], o["logits"][:, -2])


def test_cache_and_decode_steps_match_reference_and_prefill(smoke):
    """``init_encdec_cache`` (the cross K/V of both layers, empty self
    caches) and DECODE steps against the reference's, step by step; the
    decode logits equal the teacher-forced decoder's at every position."""
    cfg, jcfg, params = smoke["cfg"], smoke["jcfg"], smoke["params"]
    frames, tokens = smoke["batch"]["frames"], smoke["batch"]["tokens"]
    cache = api.init_cache(cfg, params, {"tokens": torch.from_numpy(
        tokens[:, :1]), "frames": torch.from_numpy(frames)}, DECODE,
        torch.float32)
    jcache = jed.init_encdec_cache(jcfg, smoke["jparams"],
                                   jnp.asarray(frames), DECODE, jnp.float32)
    assert sorted(cache) == ["cross_k", "cross_v", "self_k", "self_v"]
    for k in ("cross_k", "cross_v"):
        _holds(cache[k], jcache[k])
    for k in ("self_k", "self_v"):
        assert tuple(cache[k].shape) == jcache[k].shape
        assert not cache[k].any()
    jstep = jax.jit(lambda c, t, pos: jed.encdec_decode_step(
        jcfg, smoke["jparams"], c, t, pos))
    rows = []
    for pos in range(DECODE):
        tok = tokens[:, pos:pos + 1]
        logits, cache = api.decode_step(cfg, params, cache,
                                        torch.from_numpy(tok), pos)
        jl, jcache = jstep(jcache, jnp.asarray(tok), jnp.int32(pos))
        assert tuple(logits.shape) == (B, 1, cfg.vocab)
        _holds(logits, jl)
        rows.append(logits[:, 0])
    for k in ("self_k", "self_v"):
        _holds(cache[k], jcache[k])
    _holds(torch.stack(rows, dim=1), smoke["oracle"]["logits"][:, :DECODE],
           atol=1e-4, rtol=1e-4)
