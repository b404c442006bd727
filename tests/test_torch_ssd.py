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
The CUDA kernel is held against ``ssd_ref`` on the card by ``chip_smoke.py``.
"""
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
from repro_torch.kernels.ssd.ref import ssd_ref
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
    assert K.LAUNCHES == {"ssd_fwd": 0}


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
    assert K.LAUNCHES == {"ssd_fwd": 0}
    assert SSDScan.generate_vmap_rule is False
