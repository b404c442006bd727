"""Port of the SSD scan (``repro_torch.kernels.ssd``, the chunked scan and the
autograd Function of ``repro_torch.models.mamba2``) against the JAX package:
the same numpy inputs through both.

Tolerances, as the reference's own kernel tests: the port's sequential
oracle ``ssd_ref`` against the JAX ``ssd_ref`` within 1e-5 (the same
recurrence, summed in another order), against the Pallas ``ssd_fwd`` in
interpret mode within 5e-4 (the chunked algorithm against the sequential
one), bf16 inputs within 5e-2; the port's ``ssd_chunked`` against the JAX
one within 1e-4 (see the test).  Gradients within rtol 1e-4.  Every
comparison also shows that a zero output and a sign-flipped output fail it.
``ssd_phases_ref`` (the CUDA kernels' three phases, with their hi/lo bf16
split) against the JAX ``ssd_ref`` and the interpret-mode Pallas ``ssd_fwd``
within 5e-4, at inputs scaled as ``chip_smoke.py``'s (|y| of order 1).  The
CUDA kernels are held against ``ssd_ref`` and ``ssd_phases_ref`` on the card
by ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels.ssd.kernel import ssd_fwd as j_ssd_fwd
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.models.mamba2 import ssd_chunked as j_ssd_chunked
from repro_torch.convert import to_tensor
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_phases_ref, ssd_ref
from repro_torch.models.mamba2 import SSDScan, ssd_chunked, ssd_scan

# (B, S, H, P, G, N, chunk), as tests/test_kernels.py's SSD_SHAPES
SSD_SHAPES = [
    (1, 64, 4, 16, 1, 16, 16),
    (2, 128, 6, 32, 2, 16, 32),
    (1, 128, 8, 64, 1, 32, 64),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0):
    B, S, H, P, G, N, _ = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)  # softplus
    a_log = np.log(np.linspace(1.0, 8.0, H)).astype(np.float32)
    Bm = rng.randn(B, S, G, N).astype(np.float32)
    Cm = rng.randn(B, S, G, N).astype(np.float32)
    return x, dt, a_log, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _holds(got, want, tol):
    """``got`` within ``tol`` of ``want``, and the same check fails a zero
    output and a sign-flipped one."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert not np.allclose(np.zeros_like(want), want, atol=tol, rtol=tol)
    assert not np.allclose(-want, want, atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def jax_oracles():
    """The JAX ssd_ref and interpret-mode Pallas ssd_fwd at every shape,
    computed once."""
    out = {}
    for shape in SSD_SHAPES:
        ins = [jnp.asarray(a) for a in _inputs(shape)]
        out[shape] = (np.asarray(j_ssd_ref(*ins)),
                      np.asarray(j_ssd_fwd(*ins, chunk=shape[-1],
                                           interpret=True)))
    return out


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_ref_matches_jax_ref_and_pallas_kernel(shape, jax_oracles):
    j_ref, j_kernel = jax_oracles[shape]
    x, dt, a_log, Bm, Cm = _t(*_inputs(shape))
    y = ssd_ref(x, dt, a_log, Bm, Cm)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    _holds(y, j_ref, 1e-5)
    _holds(y, j_kernel, 5e-4)
    # ops' CPU modes both take the plain version; nothing is launched
    K.reset_launches()
    for mode in ("auto", "ref"):
        np.testing.assert_array_equal(
            ops.ssd(x, dt, a_log, Bm, Cm, chunk=shape[-1], mode=mode), y)
    assert K.LAUNCHES == {"ssd_fwd": 0, "ssd_fwd_kernels": 0}


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_chunked_matches_jax_chunked(shape):
    """The same chunked algorithm in both packages, within 1e-4: outputs
    reach |y| ~ 50 at these unscaled inputs, and each sums a few hundred f32
    products in another order (observed differences up to 8e-5)."""
    ins = _inputs(shape)
    want = np.asarray(j_ssd_chunked(*[jnp.asarray(a) for a in ins],
                                    chunk=shape[-1]))
    _holds(ssd_chunked(*_t(*ins), chunk=shape[-1]), want, 1e-4)


def test_ssd_bf16_inputs_match_pallas_kernel():
    """bf16 x/dt/B/C, as the reference's ``test_ssd_kernel_dtypes``: the
    port's oracle on the same bf16 values as the interpret-mode kernel."""
    shape = (1, 64, 4, 16, 1, 16, 16)
    x, dt, a_log, Bm, Cm = _inputs(shape, seed=3)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dt, Bm, Cm)]
    want = np.asarray(j_ssd_fwd(jb[0], jb[1], jnp.asarray(a_log), jb[2],
                                jb[3], chunk=16, interpret=True))
    tb = [to_tensor(np.asarray(a), "cpu") for a in jb]
    assert all(t.dtype == torch.bfloat16 for t in tb)
    y = ssd_ref(tb[0], tb[1], torch.from_numpy(a_log), tb[2], tb[3])
    _holds(y, want, 5e-2)


def test_ssd_chunk_invariance():
    """The chunked scan must not depend on the chunking, and agrees with the
    sequential oracle."""
    shape = (1, 128, 4, 16, 1, 16, 0)
    ins = _t(*_inputs(shape, seed=4))
    outs = [ssd_chunked(*ins, chunk=c) for c in (16, 32, 64, 128)]
    for o in outs[1:]:
        _holds(o, outs[0], 1e-4)
    _holds(outs[0], ssd_ref(*ins), 5e-4)


def test_ssd_scan_gradient_matches_jax_grad_of_ref():
    """The autograd Function on the CPU (plain forward, backward = vjp of
    ssd_chunked) against ``jax.grad`` of the JAX sequential ref."""
    shape = (2, 64, 4, 16, 2, 16, 16)
    ins = _inputs(shape, seed=5)
    w = np.random.RandomState(6).randn(*ins[0].shape).astype(np.float32)

    def j_loss(*a):
        return jnp.sum(j_ssd_ref(*a) * w)
    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in ins])
    wt = torch.from_numpy(w)

    def t_loss(*a):
        return (ssd_scan(*a, chunk=16) * wt).sum()
    got = grad(t_loss, argnums=(0, 1, 2, 3, 4))(*_t(*ins))
    for g, j in zip(got, want):
        j = np.asarray(j)
        tol = 1e-4 * float(np.abs(j).max())
        _holds(g, j, tol)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-4, atol=tol)


def test_ssd_scan_vmap_rule_per_row_a_log():
    """``vmap(grad(...))`` over rows, each with its own ``a_log`` (as every
    user's own params give it), goes through the Function's vmap
    staticmethod; it must equal a Python loop over the rows, forward and
    gradient."""
    shape = (2, 32, 4, 16, 1, 16, 16)
    V = 3
    rng = np.random.RandomState(7)
    x, dt, a_log, Bm, Cm = _inputs(shape, seed=8)
    xs = np.stack([x + 0.1 * rng.randn(*x.shape).astype(np.float32)
                   for _ in range(V)])
    a_logs = (a_log[None] + 0.2 * rng.randn(V, a_log.size)).astype(
        np.float32)
    xs, dt, a_logs, Bm, Cm = _t(xs, dt, a_logs, Bm, Cm)
    w = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))

    def loss(x, a, dt, Bm, Cm):
        return (ssd_scan(x, dt, a, Bm, Cm, chunk=16) * w).sum()

    fwd = vmap(lambda x, a: ssd_scan(x, dt, a, Bm, Cm, chunk=16))(xs, a_logs)
    g_v = vmap(grad(loss, argnums=(0, 1)),
               in_dims=(0, 0, None, None, None))(xs, a_logs, dt, Bm, Cm)
    for v in range(V):
        _holds(fwd[v], ssd_ref(xs[v], dt, a_logs[v], Bm, Cm), 1e-5)
        g_l = grad(loss, argnums=(0, 1))(xs[v], a_logs[v], dt, Bm, Cm)
        for a, b in zip(g_v, g_l):
            _holds(a[v], b, 1e-5 * float(b.abs().max()))
    # an unbatched a_log stays one shared (H,) row inside the rule
    g_s = vmap(grad(loss, argnums=0), in_dims=(0, None, None, None, None))(
        xs, a_logs[0], dt, Bm, Cm)
    _holds(g_s[1], grad(loss)(xs[1], a_logs[0], dt, Bm, Cm), 1e-5)


def test_ssd_scan_per_row_a_log_matches_rows():
    """The kernel's (rows, H) a_log layout, in the plain versions: each row
    scans with its own decay."""
    shape = (3, 32, 4, 16, 1, 16, 16)
    x, dt, a_log, Bm, Cm = _inputs(shape, seed=9)
    rows = np.stack([a_log, a_log + 0.3, a_log - 0.3]).astype(np.float32)
    x, dt, rows, Bm, Cm = _t(x, dt, rows, Bm, Cm)
    y = ssd_ref(x, dt, rows, Bm, Cm)
    _holds(ssd_chunked(x, dt, rows, Bm, Cm, chunk=16), y, 5e-4)
    for b in range(3):
        _holds(y[b:b + 1], ssd_ref(x[b:b + 1], dt[b:b + 1], rows[b],
                                   Bm[b:b + 1], Cm[b:b + 1]), 1e-6)


def test_ssd_kernel_wrapper_refuses_cpu_tensors_and_bad_inputs():
    """The CUDA wrapper launches or raises: a CPU tensor is refused before
    anything is built, and so are inputs the kernel does not take."""
    x, dt, a_log, Bm, Cm = _t(*_inputs((1, 32, 4, 16, 1, 16, 16)))
    K.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.ssd_fwd(x, dt, a_log, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.ssd(x, dt, a_log, Bm, Cm, chunk=16, mode="kernel")
    with pytest.raises(ValueError, match="mode"):
        ops.ssd(x, dt, a_log, Bm, Cm, chunk=16, mode="seq")
    assert K.LAUNCHES == {"ssd_fwd": 0, "ssd_fwd_kernels": 0}
    assert SSDScan.generate_vmap_rule is False


# ssd_phases_ref: H 4, P 32, N 16 and 64, G 1 and 2, shared and per-row
# a_log, nc 1 and 4 (S 64 at chunk 64 and 16), f32 and bf16 x/B/C
PHASE_NS, PHASE_GS, PHASE_CHUNKS = (16, 64), (1, 2), (64, 16)
PHASE_ROWS, PHASE_S, PHASE_H, PHASE_P = 2, 64, 4, 32
PHASE_TOL = 5e-4


def _phase_inputs(N, G, dtype, per_row, seed=11):
    """Inputs scaled as chip_smoke.ssd_inputs (dt a softplus, A from -1 to
    -16, C.B of order 1), as numpy f32; for bf16 x/B/C the values are bf16
    ones, which the JAX functions widen to the same f32."""
    rng = np.random.RandomState(seed + N + 10 * G)
    R, S, H, P = PHASE_ROWS, PHASE_S, PHASE_H, PHASE_P
    x = rng.randn(R, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(R, S, H) - 1.0)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    if per_row:
        a_log = np.stack([np.roll(a_log, 3 * r) for r in range(R)])
    Bm = (rng.randn(R, S, G, N) / N ** 0.25).astype(np.float32)
    Cm = (rng.randn(R, S, G, N) / N ** 0.25).astype(np.float32)
    if dtype == "bf16":
        x, Bm, Cm = (torch.from_numpy(a).bfloat16().float().numpy()
                     for a in (x, Bm, Cm))
    return x, dt, a_log, Bm, Cm


@functools.lru_cache(maxsize=None)
def _jit_ref():
    return jax.jit(j_ssd_ref)


@functools.lru_cache(maxsize=None)
def _jit_kernel(chunk):
    return jax.jit(functools.partial(j_ssd_fwd, chunk=chunk, interpret=True))


@pytest.fixture(scope="module")
def phase_oracles():
    """The JAX ssd_ref and the interpret-mode Pallas ssd_fwd at chunk 64 and
    16, row by row (each row with its own a_log row), for every case."""
    out = {}
    for N in PHASE_NS:
        for G in PHASE_GS:
            for dtype in ("f32", "bf16"):
                for per_row in (False, True):
                    x, dt, a_log, Bm, Cm = _phase_inputs(N, G, dtype,
                                                         per_row)
                    res = {"ref": [], 64: [], 16: []}
                    for r in range(PHASE_ROWS):
                        ins = [jnp.asarray(a[r:r + 1]) for a in (x, dt)] \
                            + [jnp.asarray(a_log[r] if per_row else a_log)] \
                            + [jnp.asarray(a[r:r + 1]) for a in (Bm, Cm)]
                        res["ref"].append(np.asarray(_jit_ref()(*ins)))
                        for c in PHASE_CHUNKS:
                            res[c].append(np.asarray(_jit_kernel(c)(*ins)))
                    out[N, G, dtype, per_row] = {
                        k: np.concatenate(v) for k, v in res.items()}
    return out


def _phase_torch(N, G, dtype, per_row):
    x, dt, a_log, Bm, Cm = _t(*_phase_inputs(N, G, dtype, per_row))
    if dtype == "bf16":
        x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    return x, dt, a_log, Bm, Cm


PHASE_CASES = [(N, G, per_row, chunk, dtype) for N in PHASE_NS
               for G in PHASE_GS for per_row in (False, True)
               for chunk in PHASE_CHUNKS for dtype in ("f32", "bf16")]


@pytest.mark.parametrize("N,G,per_row,chunk,dtype", PHASE_CASES)
def test_ssd_phases_ref_matches_jax_ref_and_pallas_kernel(
        N, G, per_row, chunk, dtype, phase_oracles):
    """The plain model of the kernels' arithmetic (end states, state pass,
    chunk scan; hi/lo bf16 split of the f32 side for bf16 inputs) within
    5e-4 of the sequential JAX ssd_ref and the chunked Pallas kernel."""
    want = phase_oracles[N, G, dtype, per_row]
    y = ssd_phases_ref(*_phase_torch(N, G, dtype, per_row), chunk=chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == want["ref"].shape
    assert 0.1 < float(np.abs(want["ref"]).mean()) < 10.0
    _holds(y, want["ref"], PHASE_TOL)
    _holds(y, want[chunk], PHASE_TOL)


@pytest.mark.parametrize("N,G,per_row,chunk", [
    c[:4] for c in PHASE_CASES if c[4] == "bf16"])
def test_ssd_phases_ref_needs_the_lo_half(N, G, per_row, chunk,
                                          phase_oracles):
    """One bf16 rounding of each f32 side (S', x w dt, the state; no lo
    half) misses 5e-4 against ssd_ref at every case, by more than ten
    times (9e-3 to 2.3e-2 at |y| ~ 0.3): the evidence that the kernels'
    hi/lo split is needed.  With the split the model lands within 1e-4."""
    want = phase_oracles[N, G, "bf16", per_row]["ref"]
    ins = _phase_torch(N, G, "bf16", per_row)
    hi_only = ssd_phases_ref(*ins, chunk=chunk, split=False)
    split = ssd_phases_ref(*ins, chunk=chunk)
    assert float(np.abs(hi_only.numpy() - want).max()) > 10 * PHASE_TOL
    assert not np.allclose(hi_only.numpy(), want, atol=PHASE_TOL,
                           rtol=PHASE_TOL)
    assert float(np.abs(split.numpy() - want).max()) < 1e-4


@pytest.mark.parametrize("shape", [
    (4, 128, 24, 64, 1, 128, 128), (8, 4096, 24, 64, 1, 128, 128),
    (1, 32768, 24, 64, 1, 128, 128), (8, 4096, 64, 64, 1, 64, 128),
    (2, 1024, 24, 64, 2, 128, 128), (2, 1024, 24, 64, 1, 128, 64),
    (1, 100, 6, 16, 3, 16, 128)])
def test_ssd_kernel_plan(shape):
    """What ssd_fwd launches, allocates and moves: one kernel (no scratch)
    for a one-chunk sequence, else three; the tiles of heads cover each
    group; the design moves at least the bound's bytes, and the states'
    four passes on top."""
    B, S, H, P, G, N, chunk = shape
    pl = K.plan(B, S, H, P, G, N, chunk, 2)
    rep = H // G
    assert pl.chunk == min(chunk, S) and pl.n_chunks == S // pl.chunk
    assert 1 <= pl.heads_per_block <= K.MAX_HEADS
    assert pl.head_tiles * pl.heads_per_block >= rep
    assert (pl.head_tiles - 1) * pl.heads_per_block < rep
    slots = B * (pl.n_chunks - 1)
    assert pl.kernels == (3 if pl.n_chunks > 1 else 1)
    assert (pl.state_floats, pl.decay_floats) == (slots * H * P * N,
                                                  slots * H)
    assert pl.scratch_bytes == 4 * (pl.state_floats + pl.decay_floats)
    bound = B * S * H * P * (2 + 4) + B * S * H * 4 + 2 * B * S * G * N * 2
    assert pl.design_bytes >= bound + 4 * 4 * pl.state_floats
    # a grid of at least two blocks per SM where the heads allow it
    blocks = B * pl.n_chunks * G * pl.head_tiles
    assert blocks >= K.TARGET_BLOCKS or pl.heads_per_block == 1
