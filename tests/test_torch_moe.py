"""Port of the MoE layer (``repro_torch.models.moe``) and of MLA
(``repro_torch.models.attention``'s ``init_mla``/``mla_forward``/
``mla_decode``) against the JAX package at ``reduce_for_smoke`` of
granite-moe-1b-a400m (4 experts, top-2, no shared experts) and of
deepseek-v3-671b (4 experts, top-2, one shared expert; MLA with q_lora 64,
kv_lora 32, nope 32 / rope 16 / v 32, 4 heads), f32: the JAX init carried
across by ``params_from_jax`` and numpy inputs through both.

Inputs.  x is a unit normal plus a fixed direction times ``LEAN``, so the
router leans the same way for every token and capacity binds at
capacity_factor 1.25 (G 3, S 40, C 25): the port drops as many (token,
slot) pairs as the reference's own routing does, counted from the
reference's formula.  With capacity_factor 8.0 nothing drops and the
output moves.  The reference's init draws the stacked experts with a
fan-in of E (its ``dense_init`` takes the leading dim), which makes
outputs of order 1e3; the experts' three matrices (and the shared experts'
down projection) are scaled by 0.1 in numpy before both packages see them,
so the outputs are of order 1.  The gradient test differentiates
sum(out * r) + aux with r of scale 0.01, so that the gradients, sums over
120 tokens, are of order 1 too, and f32 summation order stays within the
tolerance.  A zero router gives every gate 1/E: experts 0..K-1 are
chosen in order (``lax.top_k``'s order among equals) and every token past
C drops from both.

Tolerances: values within 1e-5 absolute plus 1e-5 relative; gradients
within rtol 1e-4 and atol 1e-6.  Each comparison also shows that a zero
and a sign-flipped result fail it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.tree import tree_leaves, tree_map

ATOL = RTOL = 1e-5
G, S = 3, 40
LEAN = 1.0
ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")


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


def _cfgs(arch, capacity_factor=1.25):
    jcfg = jbase.reduce_for_smoke(jconfigs.get_config(arch))
    cfg = base.reduce_for_smoke(configs.get_config(arch))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


def _x(d, seed=0):
    rs = np.random.RandomState(seed)
    lean = rs.randn(d).astype(np.float32)
    return (rs.randn(G, S, d) + LEAN * lean).astype(np.float32)


def _jax_forward(jcfg, np_p, x):
    return jax.jit(lambda p, xx: jmoe.moe_forward(jcfg, p, xx))(
        jax.tree.map(jnp.asarray, np_p), jnp.asarray(x))


def _reference_drops(jcfg, p, x):
    """(token, slot) pairs over capacity, by the reference's own routing
    (``src/repro/models/moe.py:62-73``)."""
    mo = jcfg.moe
    logits = (x @ p["router"]).astype(jnp.float32)
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), mo.top_k)
    oh = jax.nn.one_hot(top_i, mo.n_experts, dtype=jnp.float32)
    flat = oh.reshape(x.shape[0], -1, mo.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(oh.shape)
    p_sel = jnp.einsum("gske,gske->gsk", pos, oh)
    return int((p_sel >= jmoe.expert_capacity(x.shape[1], mo)).sum())


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    arch = request.param
    jcfg, cfg = _cfgs(arch)
    np_p = jax.tree.map(np.array, jax.jit(lambda k: jmoe.init_moe(
        k, jcfg))(jax.random.PRNGKey(1)))
    for k in ("wg", "wu", "wd"):
        np_p[k] *= 0.1
    if "shared" in np_p:
        np_p["shared"]["wd"] *= 0.1
    x = _x(cfg.d_model)
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, np_p=np_p, x=x,
                p=params_from_jax(np_p, device="cpu"))


def test_init_matches_reference_tree(layer):
    cfg = layer["cfg"]
    own = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)), own) == \
        jax.tree.map(lambda a: (a.shape, "torch." + str(a.dtype)),
                     layer["np_p"])
    assert ("shared" in own) == bool(cfg.moe.n_shared_experts)
    assert moe.expert_capacity(S, cfg.moe) == 25
    assert moe.expert_capacity(1, cfg.moe) == cfg.moe.top_k


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_forward_and_drops_match_reference(layer, capacity_factor):
    """out and aux at capacity 1.25 (pairs dropped, as many as the
    reference's routing drops) and at 8.0 (none dropped), which moves the
    output."""
    jcfg, cfg = _cfgs(layer["arch"], capacity_factor)
    x = layer["x"]
    jout, jaux = _jax_forward(jcfg, layer["np_p"], x)
    out, aux = moe.moe_forward(cfg, layer["p"], torch.from_numpy(x))
    _holds(out, jout)
    _holds(aux, jaux)
    want = _reference_drops(jcfg, layer["np_p"], x)
    assert int(moe.dropped_pairs(cfg, layer["p"], torch.from_numpy(x))) \
        == want
    if capacity_factor == 1.25:
        assert want >= 10
        wide, _ = moe.moe_forward(_cfgs(layer["arch"], 8.0)[1], layer["p"],
                                  torch.from_numpy(x))
        assert not np.allclose(wide.numpy(), out.numpy(), atol=ATOL,
                               rtol=RTOL)
    else:
        assert want == 0


def test_zero_router_picks_the_lowest_experts_in_order(layer):
    """Every gate 1/E: the top-k are experts 0..K-1 in order, the first C
    tokens fill both, the rest drop from both; out and aux as the
    reference's."""
    jcfg, cfg = layer["jcfg"], layer["cfg"]
    np_p = dict(layer["np_p"], router=np.zeros_like(layer["np_p"]["router"]))
    p = params_from_jax(np_p, device="cpu")
    x = torch.from_numpy(layer["x"])
    gates, top_w, top_i, pos, C = moe.route(cfg, p, x)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    assert bool((gates == 1.0 / E).all())
    assert torch.equal(top_i, torch.arange(K).expand(G, S, K))
    assert bool((top_w == 1.0 / K).all())
    assert torch.equal(pos, torch.arange(S)[None, :, None].expand(G, S, K))
    out, aux = moe.moe_forward(cfg, p, x)
    assert int(moe.dropped_pairs(cfg, p, x)) == G * K * (S - C) == \
        _reference_drops(jcfg, np_p, layer["x"])
    jout, jaux = _jax_forward(jcfg, np_p, layer["x"])
    _holds(out, jout)
    _holds(aux, jaux)
    if "shared" not in np_p:
        # only the shared experts reach a dropped token
        assert float(out[:, C:].abs().max()) == 0.0


def _scalar(out, aux, r):
    return (out * r).sum() + aux


def test_gradient_matches_reference(layer):
    """torch.func.grad against jax.grad of sum(out * r) + aux, by every
    param and by x, with capacity binding."""
    jcfg, cfg, x = layer["jcfg"], layer["cfg"], layer["x"]
    r = (0.01 * np.random.RandomState(5).randn(*x.shape)).astype(np.float32)

    def jf(p, xx):
        return _scalar(*jmoe.moe_forward(jcfg, p, xx), jnp.asarray(r))

    def tf(p, xx):
        return _scalar(*moe.moe_forward(cfg, p, xx), torch.from_numpy(r))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, layer["np_p"]), jnp.asarray(x))
    tg = grad(tf, argnums=(0, 1))(layer["p"], torch.from_numpy(x))
    for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        _holds(a, b, atol=1e-6, rtol=1e-4)


def test_vmap_over_users_equals_a_loop(layer):
    """vmap(grad) over 3 users, each one group of S tokens, as the cohort
    runs the loss, equals a loop of the same calls."""
    cfg, p, x = layer["cfg"], layer["p"], torch.from_numpy(layer["x"])
    r = torch.from_numpy(np.random.RandomState(6).randn(*x.shape[1:])
                         .astype(np.float32))

    def f(pp, xx):
        return _scalar(*moe.moe_forward(cfg, pp, xx), r)
    users = x[:, None]                                   # (3, 1, S, d)
    got = vmap(grad(f), in_dims=(None, 0))(p, users)
    outs = vmap(lambda xx: moe.moe_forward(cfg, p, xx)[0])(users)
    for u in range(G):
        want = grad(f)(p, users[u])
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_array_equal(a[u].numpy(), b.numpy())
        np.testing.assert_array_equal(
            outs[u].numpy(), moe.moe_forward(cfg, p, users[u])[0].numpy())


def test_bf16_ties_and_capacity_follow_the_router_order():
    """bf16 activations, where equal gates are common: the experts chosen
    and each pair's queue position equal the reference's ``lax.top_k``
    order on the same bf16 logits."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    rs = np.random.RandomState(2)
    # router columns 0 and 1 equal, 2 and 3 equal: ties on every token
    col = rs.randn(cfg.d_model, 2).astype(np.float32) * 0.02
    router = np.repeat(col, 2, axis=1)
    x = _x(cfg.d_model)
    p = {"router": torch.from_numpy(router)}
    _, _, top_i, pos, C = moe.route(cfg, p, torch.from_numpy(x).to(
        torch.bfloat16))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    logits = (xb @ jnp.asarray(router).astype(jnp.bfloat16)).astype(
        jnp.float32)
    _, jtop = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.top_k)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop))
    assert set(np.unique(top_i[..., 0].numpy())) <= {0, 2}
    oh = np.eye(cfg.moe.n_experts)[np.asarray(jtop)].reshape(G, -1, 4)
    jpos = ((np.cumsum(oh, 1) - oh) * oh).sum(-1).reshape(G, S, -1)
    np.testing.assert_array_equal(pos.numpy(), jpos)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

T = 12


@pytest.fixture(scope="module")
def mla():
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    np_p = jax.tree.map(np.asarray, jax.jit(lambda k: jattn.init_mla(
        k, jcfg))(jax.random.PRNGKey(3)))
    x = np.random.RandomState(4).randn(2, T, cfg.d_model).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, np_p=np_p, x=x,
                p=params_from_jax(np_p, device="cpu"))


def test_mla_init_matches_reference_tree(mla):
    own = attn.init_mla(torch.Generator().manual_seed(0), mla["cfg"])
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)), own) == \
        jax.tree.map(lambda a: (a.shape, "torch." + str(a.dtype)),
                     mla["np_p"])


def test_mla_forward_matches_reference(mla):
    """Prefill: the output and the latent cache rows (c_kv, rotated k_rope)
    at positions 0..T-1."""
    jcfg, cfg, x = mla["jcfg"], mla["cfg"], mla["x"]
    pos = np.broadcast_to(np.arange(T), (2, T)).astype(np.int32)
    jout, (jckv, jkr) = jax.jit(lambda p, xx, ps: jattn.mla_forward(
        jcfg, p, xx, positions=ps))(jax.tree.map(jnp.asarray, mla["np_p"]),
                                    jnp.asarray(x), jnp.asarray(pos))
    out, (ckv, kr) = attn.mla_forward(cfg, mla["p"], torch.from_numpy(x),
                                      positions=torch.from_numpy(pos))
    _holds(out, jout)
    _holds(ckv, jckv)
    _holds(kr, jkr)


def test_mla_decode_matches_reference_and_prefill(mla):
    """T absorbed-form decode steps from an empty latent cache: each step's
    output and the caches after the last equal the reference's, and the
    outputs equal prefill's at 5e-4, the reference's own bound."""
    jcfg, cfg, x = mla["jcfg"], mla["cfg"], mla["x"]
    m = cfg.mla
    jp = jax.tree.map(jnp.asarray, mla["np_p"])
    jc = (jnp.zeros((2, T, m.kv_lora_rank)),
          jnp.zeros((2, T, m.qk_rope_head_dim)))
    tc = (torch.zeros(2, T, m.kv_lora_rank),
          torch.zeros(2, T, m.qk_rope_head_dim))
    jstep = jax.jit(lambda p, xx, c, k, t: jattn.mla_decode(jcfg, p, xx, c,
                                                             k, t))
    outs = []
    for t in range(T):
        jo, *jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), *jc, jnp.int32(t))
        to, *tc = attn.mla_decode(cfg, mla["p"], torch.from_numpy(
            x[:, t:t + 1]), *tc, t)
        _holds(to, jo)
        outs.append(to)
    for a, b in zip(tc, jc):
        _holds(a, b)
    pos = torch.arange(T).expand(2, T)
    pre, _ = attn.mla_forward(cfg, mla["p"], torch.from_numpy(x),
                              positions=pos)
    _holds(torch.cat(outs, dim=1), pre, atol=5e-4, rtol=5e-4)
