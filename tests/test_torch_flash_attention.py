"""Port of flash attention (``repro_torch.kernels.flash_attention``, and the
``FlashAttention`` autograd Function of ``repro_torch.models.attention``)
against the JAX package: the same numpy inputs through both.

Inputs.  k is unit normal; v unit normal plus t/S along the position t, so
the output is of order 1 and moves when the window moves; q is 2 x unit
normal in f32 (logits of std 2 after the hd^-0.5 scale: a peaked softmax)
and unit normal in bf16.  The reference forms q.kᵀ in bf16 and so rounds
the logits (the Pallas kernel and the CUDA kernel do not): with q at 2 x
unit normal that rounding alone moves bf16 outputs by up to 1.1 x the
tolerance at S = 4096, and by 0.3 x with unit-normal q.

Tolerances, as the reference's own kernel tests: 2e-5 in f32 and 2e-2 in
bf16 (atol and rtol), for the port's ``attention_ref`` against the JAX
``attention_ref`` and against the Pallas ``flash_attention_fwd`` in
interpret mode.  Every comparison also shows that a zero output and a
sign-flipped output fail it, and every windowed case that the output
without the window does.  Gradients within 1e-5.

``attention_tiles_ref``, the plain model of the CUDA kernels' arithmetic
(key tiles of ``kernel.key_tile``, f32 online softmax, bf16 weights into
P·V for bf16 inputs), is held to the same tolerances against the same two,
at every case and at TILE_CASES, whose windows cross several key tiles.

The other branch of the TPU kernel (XCASES): ``causal=False`` and keys of
another length T than the queries' S, the query row i at position i
(causal with T != S is offset 0, not the reference's ``q_offset=T-S``
convention of ``attention_ref``).  Each check also fails the causal answer
(for a non-causal case) or the non-causal one (for a causal case), and
where T > S the last-S-rows answer.  At T = 200, which no key tile of 64
or 128 divides, the tile walk must also tell its answer from the one that
gives the tile's keys past T (zeros, as TMA fills them) a score of 0.
The CUDA kernels are held against both plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels.flash_attention.kernel import flash_attention_fwd as j_fwd
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                    attention_tiles_ref)
from repro_torch.models.attention import FlashAttention, flash_attention

# (B, S, Hq, Hkv, hd, window, softcap): tests/test_kernels.py's
# FLASH_SHAPES cut to S = 128 (MHA, GQA 2:1, MQA, a wide head), with
# windows and softcaps spread over them
CASES = [
    (1, 128, 4, 4, 32, 0, 0.0),
    (2, 128, 4, 2, 64, 32, 0.0),
    (1, 128, 8, 1, 64, 0, 30.0),
    (2, 128, 2, 2, 128, 64, 50.0),
]
# windows of 200 and 300 keys across key tiles of 64 and 128, GQA 2:1 and
# 4:1; rows whose first tiles are wholly masked; gemma2's head dim 256 with
# GQA 2:1 and a softcap of 5, its window of 200 across several of the bf16
# kernel's 64-key tiles
TILE_CASES = [
    (1, 512, 4, 2, 64, 200, 0.0),
    (1, 384, 8, 2, 128, 300, 5.0),
    (1, 384, 8, 4, 256, 200, 5.0),
]
# (B, S, T, Hq, Hkv, hd, causal): bidirectional self-attention (whisper's
# encoder), cross-attention to a longer and to a shorter key sequence
# (whisper's decoder against its frames), a partial tile (8 x 16), each also
# causal where T != S
XCASES = [
    (1, 256, 256, 4, 2, 64, False),
    (2, 128, 256, 4, 4, 32, False),
    (2, 128, 256, 4, 4, 32, True),
    (1, 256, 128, 4, 2, 64, False),
    (1, 256, 128, 4, 2, 64, True),
    (1, 8, 16, 8, 1, 64, False),
    (1, 8, 16, 8, 1, 64, True),
]
TOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, Hq, Hkv, hd, seed=0, q_scale=2.0, T=None):
    """q (B,S,Hq,hd), k and v (B,T,Hkv,hd) (T = S by default)."""
    T = S if T is None else T
    rng = np.random.RandomState(seed)
    q = q_scale * rng.randn(B, S, Hq, hd)
    k = rng.randn(B, T, Hkv, hd)
    v = rng.randn(B, T, Hkv, hd) + (np.arange(T) / T)[None, :, None, None]
    return [a.astype(np.float32) for a in (q, k, v)]


def _holds(got, want, tol, *wrong):
    """``got`` within ``tol`` of ``want``; a zero output, a sign-flipped one
    and every output in ``wrong`` fail the same check."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    for bad in (np.zeros_like(want), -want) + wrong:
        assert not np.allclose(np.asarray(bad, np.float32), want, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_attention_ref_matches_jax_ref_and_pallas_kernel(case, dname):
    B, S, Hq, Hkv, hd, window, cap = case
    jdt, tdt = DTYPES[dname]
    ins = _inputs(B, S, Hq, Hkv, hd, q_scale=2.0 if dname == "f32" else 1.0)
    jins = [jnp.asarray(a, jdt) for a in ins]
    tins = [torch.from_numpy(a).to(tdt) for a in ins]
    kw = dict(causal=True, window=window, softcap=cap)
    K.reset_launches()
    got = ops.flash_attention(*tins, **kw)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, Hq, hd)
    assert K.LAUNCHES["flash_attention_fwd"] == 0   # CPU: the plain version
    np.testing.assert_array_equal(
        got.float().numpy(), attention_ref(*tins, **kw).float().numpy())
    wrong = ()
    if window:
        wrong = (attention_ref(*tins, causal=True, softcap=cap).float(),)
    tol = TOL[dname]
    _holds(got.float(), j_ref(*jins, **kw), tol, *wrong)
    _holds(got.float(), j_fwd(*jins, **kw, block_q=64, block_k=64,
                              interpret=True), tol, *wrong)


@pytest.mark.parametrize("case", CASES + TILE_CASES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_attention_tiles_ref_matches_jax_ref_and_pallas_kernel(case, dname):
    B, S, Hq, Hkv, hd, window, cap = case
    jdt, tdt = DTYPES[dname]
    ins = _inputs(B, S, Hq, Hkv, hd, q_scale=2.0 if dname == "f32" else 1.0)
    jins = [jnp.asarray(a, jdt) for a in ins]
    tins = [torch.from_numpy(a).to(tdt) for a in ins]
    kw = dict(causal=True, window=window, softcap=cap)
    block_k = K.key_tile(tdt, hd)
    got = attention_tiles_ref(*tins, **kw, block_k=block_k)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, Hq, hd)
    wrong = ()
    if window:
        wrong = (attention_tiles_ref(*tins, causal=True, softcap=cap,
                                     block_k=block_k).float(),)
    tol = TOL[dname]
    _holds(got.float(), j_ref(*jins, **kw), tol, *wrong)
    _holds(got.float(), j_fwd(*jins, **kw, block_q=64, block_k=64,
                              interpret=True), tol, *wrong)


@pytest.mark.parametrize("block_k", [32, 64, 128, 512])
def test_attention_tiles_ref_tile_size_moves_f32_by_rounding_only(block_k):
    """In f32 the tile walk changes only the order of the f32 rescales: any
    ``block_k`` (one tile of the whole sequence included) agrees with the
    materialized softmax of ``attention_ref`` within 2e-6."""
    B, S, Hq, Hkv, hd, window, cap = TILE_CASES[0]
    tins = [torch.from_numpy(a) for a in _inputs(B, S, Hq, Hkv, hd)]
    kw = dict(causal=True, window=window, softcap=cap)
    got = attention_tiles_ref(*tins, **kw, block_k=block_k)
    _holds(got, attention_ref(*tins, **kw), 2e-6)


def test_key_tile_follows_the_kernel_dispatch():
    """bf16 runs the wgmma kernel at every head dim, with 128-key tiles at
    hd 64 and 128 and 64-key tiles at hd 256; f32 runs the CUDA-core
    kernel's 64-key tiles."""
    assert K.WGMMA_HEAD_DIMS == K.HEAD_DIMS == (64, 128, 256)
    assert K.key_tile(torch.bfloat16, 64) == K.WGMMA_BLOCK_K[64] == 128
    assert K.key_tile(torch.bfloat16, 128) == K.WGMMA_BLOCK_K[128] == 128
    assert K.key_tile(torch.bfloat16, 256) == K.WGMMA_BLOCK_K[256] == 64
    for hd in K.HEAD_DIMS:
        assert K.key_tile(torch.float32, hd) == K.TILE == 64


def test_attention_ref_without_causal_mask():
    ins = _inputs(1, 64, 4, 2, 32, seed=3)
    got = attention_ref(*map(torch.from_numpy, ins), causal=False)
    want = j_ref(*map(jnp.asarray, ins), causal=False)
    causal = attention_ref(*map(torch.from_numpy, ins))
    _holds(got, want, TOL["f32"], causal)


def _xwrong(fn, tins, causal, S, T, **kw):
    """The wrong answers a cross-length case must fail: the other mask and,
    where T > S, the last S rows of a T-row sequence."""
    wrong = [fn(*tins, causal=not causal, **kw).float()]
    if causal and T > S:
        wrong.append(fn(*tins, causal=True, q_offset=T - S, **kw).float())
    return tuple(wrong)


@pytest.mark.parametrize("case", XCASES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_non_causal_and_cross_length_match_jax_ref_and_pallas(case, dname):
    """The branch the encdec family runs: both plain versions against the
    JAX ``attention_ref`` and the interpret-mode Pallas kernel, k and v of
    length T."""
    B, S, T, Hq, Hkv, hd, causal = case
    jdt, tdt = DTYPES[dname]
    ins = _inputs(B, S, Hq, Hkv, hd, seed=7, T=T,
                  q_scale=2.0 if dname == "f32" else 1.0)
    jins = [jnp.asarray(a, jdt) for a in ins]
    tins = [torch.from_numpy(a).to(tdt) for a in ins]
    K.reset_launches()
    got = ops.flash_attention(*tins, causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, Hq, hd)
    assert K.LAUNCHES["flash_attention_fwd"] == 0   # CPU: the plain version
    tiles = attention_tiles_ref(*tins, causal=causal,
                                block_k=K.key_tile(tdt, hd))
    jwant = j_ref(*jins, causal=causal)
    pallas = j_fwd(*jins, causal=causal, block_q=64, block_k=64,
                   interpret=True)
    tol = TOL[dname]
    for out in (got, tiles):
        wrong = _xwrong(attention_ref, tins, causal, S, T)
        _holds(out.float(), jwant, tol, *wrong)
        _holds(out.float(), pallas, tol, *wrong)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("S,causal", [(200, False), (96, False),
                                      (256, True)])
def test_attention_tiles_ref_masks_the_tail_past_t(S, causal, block_k,
                                                   dname):
    """T = 200 keys in tiles of 64 or 128: the tile walk against
    ``attention_ref``, and not the answer that scores the last tile's keys
    past T (zeros, as the wgmma kernel's TMA loads give them) as 0."""
    T, Hq, Hkv, hd = 200, 4, 2, 64
    _, tdt = DTYPES[dname]
    ins = _inputs(1, S, Hq, Hkv, hd, seed=8, T=T,
                  q_scale=2.0 if dname == "f32" else 1.0)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in ins)
    got = attention_tiles_ref(q, k, v, causal=causal, block_k=block_k)
    want = attention_ref(q, k, v, causal=causal)
    pad = -T % block_k
    kz, vz = (torch.cat([t, t.new_zeros(1, pad, Hkv, hd)], dim=1)
              for t in (k, v))
    unmasked_tail = attention_ref(q, kz, vz, causal=causal)
    assert not torch.equal(unmasked_tail, want)
    _holds(got.float(), want.float(), TOL[dname], unmasked_tail.float(),
           *_xwrong(attention_ref, (q, k, v), causal, S, T))


@pytest.mark.parametrize("window,cap", [(0, 0.0), (16, 5.0)])
def test_plain_versions_take_the_last_rows_by_q_offset(window, cap):
    """``q_offset`` puts the queries at the keys' last positions: the last
    rows held against all keys (or their windows' keys) give the rows of
    the whole computation, in both plain versions."""
    q, k, v = map(torch.from_numpy, _inputs(1, 96, 4, 2, 32, seed=5))
    kw = dict(causal=True, window=window, softcap=cap)
    whole = attention_ref(q, k, v, **kw)[:, -24:]
    L = window + 24 if window else 96
    assert torch.allclose(attention_ref(q[:, -24:], k[:, -L:], v[:, -L:],
                                        q_offset=L - 24, **kw), whole,
                          atol=1e-6, rtol=0)
    tiles = attention_tiles_ref(q[:, -24:], k[:, -L:], v[:, -L:],
                                q_offset=L - 24, block_k=16, **kw)
    _holds(tiles, whole, 2e-6)
    assert not torch.allclose(attention_ref(q[:, -24:], k, v, **kw), whole,
                              atol=1e-3)


def test_ops_modes_and_kernel_wrapper_refuse_cpu_tensors():
    q, k, v = map(torch.from_numpy, _inputs(1, 64, 4, 4, 64))
    ref = attention_ref(q, k, v, window=16)
    assert torch.equal(ops.flash_attention(q, k, v, window=16, mode="ref"),
                       ref)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.flash_attention(q, k, v, mode="kernel")
    with pytest.raises(ValueError, match="mode must be one of"):
        ops.flash_attention(q, k, v, mode="pallas")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.flash_attention_fwd(q, k, v)
    # the non-causal, cross-length branch on a CPU tensor: refused too
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.flash_attention(q, k[:, :32], v[:, :32], causal=False,
                            mode="kernel")
    assert K.LAUNCHES["flash_attention_fwd"] == 0


@pytest.mark.parametrize("window,cap", [(0, 0.0), (16, 0.0), (24, 30.0)])
def test_flash_attention_gradient_matches_jax_vjp_of_sdpa(window, cap):
    """The Function's backward is the vjp of the plain masked sdpa: against
    ``jax.vjp`` of the reference ``sdpa`` with ``causal_mask``, f32, GQA."""
    B, S, Hq, Hkv, hd = 2, 48, 4, 2, 32
    ins = _inputs(B, S, Hq, Hkv, hd, seed=1)
    g = np.random.RandomState(2).randn(B, S, Hq, hd).astype(np.float32)

    def jfn(q, k, v):
        return jattn.sdpa(q, k, v, mask=jattn.causal_mask(S, S, 0, window),
                          cap=cap)
    jout, jvjp = jax.vjp(jfn, *map(jnp.asarray, ins))
    jgrads = jvjp(jnp.asarray(g))
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = flash_attention(*tins, window=window, cap=cap)
    grads = torch.autograd.grad(out, tins, torch.from_numpy(g))
    _holds(out.detach(), jout, 1e-5)
    for a, b in zip(grads, jgrads):
        _holds(a, b, 1e-5)


@pytest.mark.parametrize("S,T,causal", [(40, 40, False), (24, 56, False),
                                        (24, 56, True)])
def test_flash_attention_gradient_non_causal_and_cross(S, T, causal):
    """The Function's backward on the encdec branch: against ``jax.vjp`` of
    the reference ``sdpa`` with no mask (``causal=False``) or its
    ``causal_mask(S, T, 0)``, f32, GQA, k and v of length T."""
    B, Hq, Hkv, hd = 2, 4, 2, 32
    ins = _inputs(B, S, Hq, Hkv, hd, seed=9, T=T)
    g = np.random.RandomState(10).randn(B, S, Hq, hd).astype(np.float32)
    mask = jattn.causal_mask(S, T, 0) if causal else None

    def jfn(q, k, v):
        return jattn.sdpa(q, k, v, mask=mask)
    jout, jvjp = jax.vjp(jfn, *map(jnp.asarray, ins))
    jgrads = jvjp(jnp.asarray(g))
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = flash_attention(*tins, causal=causal)
    grads = torch.autograd.grad(out, tins, torch.from_numpy(g))
    other = flash_attention(*(t.detach() for t in tins), causal=not causal)
    _holds(out.detach(), jout, 1e-5, other)
    for a, b in zip(grads, jgrads):
        _holds(a, b, 1e-5)


def test_flash_attention_vmap_grad_matches_per_user_loop():
    """``vmap(grad(...))`` over a cohort of 3, with q per user and k/v
    unbatched (broadcast by the vmap rule), and with all three per user,
    equals a Python loop over the users."""
    U, S, H, hd, window = 3, 32, 2, 32, 8
    rng = np.random.RandomState(4)
    qs = torch.from_numpy(rng.randn(U, 1, S, H, hd).astype(np.float32))
    k, v = (torch.from_numpy(a[0])
            for a in _inputs(1, S, H, H, hd, seed=5)[1:])
    w = torch.from_numpy(rng.randn(1, S, H, hd).astype(np.float32))

    def loss(q, k, v):
        return (flash_attention(q, k, v, window=window) * w).sum()

    assert FlashAttention.generate_vmap_rule is False
    fwd = vmap(lambda q: flash_attention(q, k[None], v[None],
                                         window=window))(qs)
    g_v = vmap(grad(loss, argnums=(0, 1, 2)), in_dims=(0, None, None))(
        qs, k[None], v[None])
    for u in range(U):
        _holds(fwd[u], flash_attention(qs[u], k[None], v[None],
                                       window=window), 1e-6)
        g_u = grad(loss, argnums=(0, 1, 2))(qs[u], k[None], v[None])
        for a, b in zip(g_v, g_u):
            _holds(a[u], b, 1e-6)
    ks = torch.stack([k[None] * (1 + 0.1 * u) for u in range(U)])
    vs = torch.stack([v[None] - 0.2 * u for u in range(U)])
    g_all = vmap(grad(loss, argnums=(0, 1, 2)))(qs, ks, vs)
    for u in range(U):
        g_u = grad(loss, argnums=(0, 1, 2))(qs[u], ks[u], vs[u])
        for a, b in zip(g_all, g_u):
            _holds(a[u], b, 1e-6)


def test_flash_attention_vmap_rule_takes_cross_length_keys():
    """The vmap rule folds users into the batch with k and v of another
    length than q (the cohort's encoder frames against its decoder
    tokens), non-causal: ``vmap(grad(...))`` equals the per-user loop."""
    U, S, T, H, hd = 3, 12, 20, 2, 32
    rng = np.random.RandomState(11)
    qs = torch.from_numpy(rng.randn(U, 1, S, H, hd).astype(np.float32))
    ks = torch.from_numpy(rng.randn(U, 1, T, H, hd).astype(np.float32))
    vs = torch.from_numpy(rng.randn(U, 1, T, H, hd).astype(np.float32))
    w = torch.from_numpy(rng.randn(1, S, H, hd).astype(np.float32))

    def loss(q, k, v):
        return (flash_attention(q, k, v, causal=False) * w).sum()

    g_all = vmap(grad(loss, argnums=(0, 1, 2)))(qs, ks, vs)
    fwd = vmap(lambda q, k, v: flash_attention(q, k, v, causal=False))(
        qs, ks, vs)
    for u in range(U):
        _holds(fwd[u], flash_attention(qs[u], ks[u], vs[u], causal=False),
               1e-6, flash_attention(qs[u], ks[u], vs[u]))
        g_u = grad(loss, argnums=(0, 1, 2))(qs[u], ks[u], vs[u])
        for a, b in zip(g_all, g_u):
            _holds(a[u], b, 1e-6)
