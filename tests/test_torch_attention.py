"""Port of the attention layers (``repro_torch.models.attention`` and the
rotary embedding and SwiGLU MLP of ``repro_torch.models.layers``) against
the JAX package at the hybrid's smoke widths (``reduce_for_smoke(zamba2-1.2b)``:
d 256, 4 heads of 32, d_ff 1024, the shared block's d_in 512, f32): the JAX
init carried across by ``params_from_jax`` and numpy inputs through both.

Tolerances: 1e-5 absolute plus 1e-5 relative on values of order 1 (f32
matrix products sum in other orders).  Each comparison also shows that a
zero and a sign-flipped result fail it, and each windowed attention that
the output without the window does.  On the CPU ``attn_forward`` runs the
plain ``attention_ref`` inside its ``FlashAttention`` Function, the JAX
package the plain ``sdpa``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.tree import tree_map

ATOL = RTOL = 1e-5
B, S = 2, 48


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
    jcfg = jbase.reduce_for_smoke(jconfigs.get_config("zamba2-1.2b"))
    cfg = base.reduce_for_smoke(configs.get_config("zamba2-1.2b"))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    d_in = 2 * cfg.d_model
    np_attn = jax.tree.map(np.asarray, jattn.init_attn(k1, jcfg, d_in=d_in))
    np_mlp = jax.tree.map(np.asarray, jlayers.init_mlp(k2, jcfg.d_model,
                                                       jcfg.d_ff))
    rng = np.random.RandomState(0)
    x = rng.randn(B, S, d_in).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, np_attn=np_attn, np_mlp=np_mlp, x=x,
                attn=params_from_jax(np_attn, device="cpu"),
                mlp=params_from_jax(np_mlp, device="cpu"))


def test_init_shapes_match_reference(smoke):
    cfg = smoke["cfg"]
    g = torch.Generator().manual_seed(0)
    own = {"attn": attn.init_attn(g, cfg, d_in=2 * cfg.d_model),
           "mlp": layers.init_mlp(g, cfg.d_model, cfg.d_ff)}
    want = {"attn": smoke["np_attn"], "mlp": smoke["np_mlp"]}
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)), own) == \
        jax.tree.map(lambda a: (a.shape, "torch." + str(a.dtype)), want)
    # MLA at these widths: the port's init has the reference's tree, and
    # mla_forward from the reference's init gives the reference's output
    mcfg = dataclasses.replace(cfg, mla=base.MLAConfig(
        q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
        qk_rope_head_dim=16, v_head_dim=32))
    jmcfg = dataclasses.replace(smoke["jcfg"], mla=jbase.MLAConfig(
        **dataclasses.asdict(mcfg.mla)))
    np_mla = jax.tree.map(np.asarray, jax.jit(lambda k: jattn.init_mla(
        k, jmcfg))(jax.random.PRNGKey(1)))
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                    attn.init_mla(g, mcfg)) == \
        jax.tree.map(lambda a: (a.shape, "torch." + str(a.dtype)), np_mla)
    x = np.ascontiguousarray(smoke["x"][..., :cfg.d_model])
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want, _ = jax.jit(lambda p, xx, ps: jattn.mla_forward(
        jmcfg, p, xx, positions=ps))(np_mla, x, pos)
    got, _ = attn.mla_forward(mcfg, params_from_jax(np_mla, device="cpu"),
                              torch.from_numpy(x),
                              positions=torch.from_numpy(pos))
    _holds(got, want)
    # cross-attention decode from the reference's init (its d_in is d) of
    # one token against 40 encoder frames, against the reference's, and
    # not against the first 20 frames alone
    np_x = jax.tree.map(np.asarray, jattn.init_attn(
        jax.random.PRNGKey(2), smoke["jcfg"]))
    rs = np.random.RandomState(3)
    hd = cfg.resolved_head_dim
    xt = rs.randn(B, 1, cfg.d_model).astype(np.float32)
    ek, ev = (rs.randn(B, 40, cfg.n_kv_heads, hd).astype(np.float32)
              for _ in range(2))
    got = attn.cross_attn_decode(cfg, params_from_jax(np_x, device="cpu"),
                                 *map(torch.from_numpy, (xt, ek, ev)))
    want = jattn.cross_attn_decode(smoke["jcfg"], np_x,
                                   *map(jnp.asarray, (xt, ek, ev)))
    short = jattn.cross_attn_decode(smoke["jcfg"], np_x, jnp.asarray(xt),
                                    jnp.asarray(ek[:, :20]),
                                    jnp.asarray(ev[:, :20]))
    assert tuple(got.shape) == (B, 1, cfg.d_model)
    _holds(got, want, np.asarray(short))


def test_rope_matches_reference():
    rng = np.random.RandomState(1)
    x = rng.randn(B, S, 4, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(S) * 7 + 3, (B, S)).astype(np.int32)
    np.testing.assert_allclose(layers.rope_freqs(32, 1e4).numpy(),
                               np.asarray(jlayers.rope_freqs(32, 1e4)),
                               rtol=1e-6)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    _holds(got, want, x)                      # position 0 would not move x
    xb = torch.from_numpy(x).bfloat16()
    got_b = layers.apply_rope(xb, torch.from_numpy(pos), 1e4)
    assert got_b.dtype == torch.bfloat16
    _holds(got_b.float(), jlayers.apply_rope(jnp.asarray(x, jnp.bfloat16),
                                             jnp.asarray(pos), 1e4),
           atol=1e-2, rtol=1e-2)


def test_mlp_matches_reference(smoke):
    x = np.random.RandomState(2).randn(B, S, smoke["cfg"].d_model).astype(
        np.float32)
    got = layers.mlp_forward(smoke["mlp"], torch.from_numpy(x))
    want = jlayers.mlp_forward(jax.tree.map(jnp.asarray, smoke["np_mlp"]),
                               jnp.asarray(x))
    _holds(got, want)


@pytest.mark.parametrize("window", [0, 16])
def test_attn_forward_matches_reference(smoke, window):
    jcfg, cfg, x = smoke["jcfg"], smoke["cfg"], smoke["x"]
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, smoke["np_attn"])
    want, (jk, jv) = jattn.attn_forward(jcfg, jp, jnp.asarray(x),
                                        positions=jnp.asarray(pos),
                                        window=window)
    K.reset_launches()
    got, (k, v) = attn.attn_forward(cfg, smoke["attn"], torch.from_numpy(x),
                                    positions=torch.from_numpy(pos),
                                    window=window)
    assert K.LAUNCHES["flash_attention_fwd"] == 0  # CPU: the plain version
    wrong = ()
    if window:
        wrong = (attn.attn_forward(cfg, smoke["attn"], torch.from_numpy(x),
                                   positions=torch.from_numpy(pos))[0],)
    _holds(got, want, *wrong)
    _holds(k, jk)
    _holds(v, jv)
    # the plain paths: no causal mask, and a causal mask with a local_flag
    # that turns the window off (gemma2's global layers)
    for kw in (dict(causal=False), dict(window=8, local_flag=False)):
        want = jattn.attn_forward(jcfg, jp, jnp.asarray(x),
                                  positions=jnp.asarray(pos), **kw)[0]
        got = attn.attn_forward(cfg, smoke["attn"], torch.from_numpy(x),
                                positions=torch.from_numpy(pos), **kw)[0]
        _holds(got, want)


def test_causal_mask_matches_reference():
    for args in ((8, 8, 0, 0), (8, 12, 4, 3), (16, 16, 0, 5)):
        np.testing.assert_array_equal(attn.causal_mask(*args).numpy(),
                                      np.asarray(jattn.causal_mask(*args)))
    np.testing.assert_array_equal(
        attn.causal_mask(8, 8, 0, 3, local_flag=torch.tensor(False)).numpy(),
        np.asarray(jattn.causal_mask(8, 8, 0, 3, jnp.bool_(False))))


@pytest.mark.parametrize("pos,mask_pos,rope_pos", [
    (5, None, None),          # a plain cache: write, rope and mask at pos
    (3, 15, 19),              # a wrapped ring: write slot 3 of 16, rope at
                              # the absolute position 19, every entry live
])
def test_attn_decode_matches_reference(smoke, pos, mask_pos, rope_pos):
    jcfg, cfg = smoke["jcfg"], smoke["cfg"]
    T, hd = 16, cfg.resolved_head_dim
    rng = np.random.RandomState(3)
    x = rng.randn(B, 1, 2 * cfg.d_model).astype(np.float32)
    kc = rng.randn(B, T, cfg.n_kv_heads, hd).astype(np.float32)
    vc = rng.randn(B, T, cfg.n_kv_heads, hd).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, smoke["np_attn"])
    kw = dict(rope_pos=rope_pos, mask_pos=mask_pos)
    want = jattn.attn_decode(jcfg, jp, jnp.asarray(x), jnp.asarray(kc),
                             jnp.asarray(vc), pos, **kw)
    got = attn.attn_decode(cfg, smoke["attn"], torch.from_numpy(x),
                           torch.from_numpy(kc), torch.from_numpy(vc), pos,
                           **kw)
    # without the override the mask would stop at pos and the rotary
    # position would be the slot
    wrong = ()
    if mask_pos is not None:
        wrong = (attn.attn_decode(cfg, smoke["attn"], torch.from_numpy(x),
                                  torch.from_numpy(kc), torch.from_numpy(vc),
                                  pos)[0],)
    _holds(got[0], want[0], *wrong)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    # only the written row changed
    changed = np.nonzero((got[1].numpy() != kc).any(axis=(0, 2, 3)))[0]
    assert changed.tolist() == [pos]
