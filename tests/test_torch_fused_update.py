"""Port of the server-apply kernels (``repro_torch.kernels.fused_update``):
the plain PyTorch versions against the JAX reference's plain versions and
against its Pallas kernels run in interpret mode, plus the dispatch and the
checks of the CUDA wrappers that hold without a card.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.

Tolerances: f32 ``apply_scaled`` atol 1e-6 (one elementwise f32 pass, as the
reference's kernel tests); f32 ``apply_rows`` atol 1e-5 / rtol 1e-4 (the
reductions sum the M rows in different orders); a bf16 output rtol 2^-7 /
atol 1e-5, about one bf16 ulp (a sum rounded from a slightly different f32
value).  The inputs make the update of the order of ``w``, so that a no-op
or a sign-flipped apply fails these limits, which
``test_tolerances_reject_noop_and_sign_flip`` holds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_update import kernel as JK
from repro.kernels.fused_update import ref as JR
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.fused_update import ops
from repro_torch.kernels.fused_update import ref as R

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (w dtype, Δ dtype): f32 params with bf16 deltas is what
# PersAFLConfig(delta_dtype="bfloat16") hands the applies
CASES = {"float32": ("float32", "float32"),
         "bfloat16": ("bfloat16", "bfloat16"),
         "w32_d16": ("float32", "bfloat16")}
F32_TOL = dict(atol=1e-6, rtol=0)
ROWS_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)
ROWS_N = 8192 + 5


def _tol(kind, w_dtype):
    if w_dtype == "bfloat16":
        return BF16_TOL
    return F32_TOL if kind == "scaled" else ROWS_TOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the shapes are small: one intra-op thread runs them faster and leaves
    # the cores to the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _port(*arrays):
    """JAX arrays -> CPU tensors through the port's converter."""
    return params_from_jax([np.asarray(a) for a in arrays], "cpu")


def _scaled_inputs(shape, case):
    """w, Δ of the same magnitude, so s·Δ (s = 0.37) is of the order of w."""
    w_dt, d_dt = CASES[case]
    rng = np.random.RandomState(sum(shape))
    return (jnp.asarray(rng.randn(*shape), DTYPES[w_dt][0]),
            jnp.asarray(rng.randn(*shape), DTYPES[d_dt][0]), 0.37)


def _rows_inputs(m, case):
    """w, an [M, n] stack and weights with Σᵢ sᵢ·Δᵢ of the order of w."""
    w_dt, d_dt = CASES[case]
    rng = np.random.RandomState(m)
    w = jnp.asarray(rng.randn(ROWS_N), DTYPES[w_dt][0])
    stack = jnp.asarray(rng.randn(m, ROWS_N), DTYPES[d_dt][0])
    weights = (rng.rand(m) / np.sqrt(m)).astype(np.float32)
    weights[1::3] = 0.0      # zero-weight rows with finite contents: inert
    return w, stack, weights


@pytest.mark.parametrize("shape", [(5,), (8192 + 5,), (3, 3, 8, 16)])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_scaled_ref_matches_jax_ref_and_pallas(shape, case):
    w, d, s = _scaled_inputs(shape, case)
    want_ref = JR.apply_scaled_ref(w, d, s)
    want_pallas = JK.apply_scaled(w, d, s, interpret=True)
    tw, td = _port(w, d)
    got = R.apply_scaled_ref(tw, td, s)
    assert got.dtype == DTYPES[CASES[case][0]][1]
    assert tuple(got.shape) == shape
    tol = _tol("scaled", CASES[case][0])
    np.testing.assert_allclose(_f32(got), _f32(want_ref), **tol)
    np.testing.assert_allclose(_f32(got), _f32(want_pallas), **tol)


@pytest.mark.parametrize("m", [1, 3, 8, 300])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_rows_ref_matches_jax_ref_and_pallas(m, case):
    w, stack, weights = _rows_inputs(m, case)
    want_ref = JR.apply_rows_ref(w, stack, weights)
    tw, ts = _port(w, stack)
    got = R.apply_rows_ref(tw, ts, torch.from_numpy(weights))
    assert got.dtype == DTYPES[CASES[case][0]][1]
    assert tuple(got.shape) == (ROWS_N,)
    tol = _tol("rows", CASES[case][0])
    np.testing.assert_allclose(_f32(got), _f32(want_ref), **tol)
    if CASES[case][0] == "bfloat16" and m > JK.ROW_BLOCK:
        # the Pallas kernel rounds its partial sum to bf16 between 128-row
        # chunks (kernel.py:120-126) while both plain versions, and the
        # port's kernel, keep the whole sum in f32: at M=300 the kernel is
        # not the function the port computes, so only the ref is compared
        return
    want_pallas = JK.apply_rows(w, stack, weights, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want_pallas), **tol)


@pytest.mark.parametrize("kind", ["scaled", "rows"])
@pytest.mark.parametrize("case", list(CASES))
def test_tolerances_reject_noop_and_sign_flip(kind, case):
    # the limits above must fail an apply that leaves w as it was or adds
    # the update instead of subtracting it, on the inputs the tests use
    if kind == "scaled":
        w, d, s = _scaled_inputs((8192 + 5,), case)
        want = JR.apply_scaled_ref(w, d, s)
    else:
        w, stack, weights = _rows_inputs(300, case)
        want = JR.apply_rows_ref(w, stack, weights)
    tol = _tol(kind, CASES[case][0])
    flipped = (2 * w.astype(jnp.float32) - want.astype(jnp.float32)
               ).astype(w.dtype)
    for wrong in (w, flipped):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(_f32(wrong), _f32(want), **tol)


def test_tree_fronts_auto_on_cpu_take_the_plain_version():
    rng = np.random.RandomState(0)
    w = {"a": torch.from_numpy(rng.randn(4, 3).astype(np.float32)),
         "b": [torch.from_numpy(rng.randn(7).astype(np.float32))]}
    d = {"a": torch.ones(4, 3), "b": [torch.ones(7)]}
    out = ops.apply_delta_tree(w, d, 0.5)
    np.testing.assert_array_equal(out["a"].numpy(), (w["a"] - 0.5).numpy())
    stack = {"a": torch.ones(2, 4, 3), "b": [torch.ones(2, 7)]}
    out = ops.apply_rows_tree(w, stack, torch.tensor([0.25, 0.5]))
    np.testing.assert_allclose(out["b"][0].numpy(), (w["b"][0] - 0.75).numpy(),
                               **F32_TOL)
    assert K.LAUNCHES == {"apply_scaled": 0, "apply_rows": 0,
                          "apply_rows_q": 0}


@pytest.mark.parametrize("mode", ["kernel", "seq", "bogus"])
def test_tree_fronts_refuse_kernel_on_cpu_and_unknown_modes(mode):
    w = {"a": torch.zeros(3)}
    with pytest.raises(ValueError):
        ops.apply_delta_tree(w, {"a": torch.ones(3)}, 1.0, mode=mode)
    with pytest.raises(ValueError):
        ops.apply_rows_tree(w, {"a": torch.ones(2, 3)}, torch.ones(2),
                            mode=mode)


def test_wrappers_check_inputs_before_building():
    # every refusal below happens in Python, before nvcc or the card
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.apply_scaled(torch.zeros(4), torch.zeros(4), 1.0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.apply_rows(torch.zeros(4), torch.zeros(2, 4), torch.zeros(2))
    with pytest.raises(TypeError, match="torch.Tensor"):
        K.apply_scaled(np.zeros(4), torch.zeros(4), 1.0)


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    # the library name carries the hash of its sources
    assert _build.library_path("fused_update").name.startswith(
        "libfused_update-")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_keeps_tree_and_dtype(dtype):
    jdt, tdt = DTYPES[dtype]
    tree = {"conv": [{"b": np.asarray(jnp.arange(3, dtype=jdt)),
                      "w": np.asarray(jnp.ones((2, 2), jdt))}],
            "fc": [{"w": np.asarray(jnp.full((2,), 0.5, jdt))}]}
    port = params_from_jax(tree, "cpu")
    assert port["conv"][0]["w"].dtype == tdt
    back = params_to_numpy(port)
    for a, b in ((tree["conv"][0]["b"], back["conv"][0]["b"]),
                 (tree["conv"][0]["w"], back["conv"][0]["w"]),
                 (tree["fc"][0]["w"], back["fc"][0]["w"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_f32(a), _f32(b))
