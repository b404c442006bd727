"""Port of the fused-update kernels (``repro_torch.kernels.fused_update``),
the local steps and the server applies: the plain PyTorch versions against
the JAX reference's plain versions and against its Pallas kernels run in
interpret mode, the tree fronts against the reference's, plus the dispatch
and the checks of the CUDA wrappers that hold without a card.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.

Tolerances: f32 ``apply_scaled`` atol 1e-6 (one elementwise f32 pass, as the
reference's kernel tests); f32 ``apply_rows`` atol 1e-5 / rtol 1e-4 (the
reductions sum the M rows in different orders); a bf16 output rtol 2^-7 /
atol 1e-5, about one bf16 ulp (a sum rounded from a slightly different f32
value).  The inputs make the update of the order of ``w``, so that a no-op
or a sign-flipped apply fails these limits, which
``test_tolerances_reject_noop_and_sign_flip`` holds.  The local steps
(``sgd_step``, ``prox_inner``, ``prox_outer``) take the same limits: f32
atol 1e-6, bf16 about one ulp, with η·|g| and ηλ·|w − θ| of the order of
``|w|`` (at η = 0.01 and unit-normal g a no-op would pass one bf16 ulp),
and the f32 plain versions must equal the reference's bit for bit, which
is what tells the two roundings of the outer step's ηλ apart.
"""
import collections

import jax
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
from repro_torch.tree import tree_leaves, tree_unflatten


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)

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


# the local steps: scalars as the paper's Options A and C use them (Option A
# η, Option C's η_in and λ), η = 0.01 and λ = 20 being a pair whose f64
# product rounds to another f32 than f32(η)·f32(λ); g scaled so that each
# update is of the order of w
LOCAL = {"sgd_step": (dict(eta=0.01), 50.0),
         "prox_inner": (dict(eta_in=0.02, lam=20.0), 25.0),
         "prox_outer": (dict(eta=0.01, lam=20.0), None)}


def _local_inputs(kind, shape, case):
    """The step's tensor operands, first operand (the output's dtype) first:
    (w, g), (θ, g, w) or (w, θ); the second dtype of ``case`` goes to every
    other operand."""
    first, other = (DTYPES[d][0] for d in CASES[case])
    rng = np.random.RandomState(sum(shape) + len(kind))
    x = rng.randn(*shape)
    g_scale = LOCAL[kind][1]
    if kind == "sgd_step":
        ops_ = [x, g_scale * rng.randn(*shape)]
    elif kind == "prox_inner":
        ops_ = [x, g_scale * rng.randn(*shape), rng.randn(*shape)]
    else:
        ops_ = [x, rng.randn(*shape)]
    return [jnp.asarray(a, first if i == 0 else other)
            for i, a in enumerate(ops_)]


def _local(kind, pkg, arrays):
    """One local step through ``pkg``'s ref module (``JR`` or ``R``) or the
    Pallas kernels (``JK``, interpret mode)."""
    kw = dict(LOCAL[kind][0])
    if pkg is JK:
        kw["interpret"] = True
    fn = getattr(pkg, kind if pkg is JK else kind + "_ref")
    return fn(*arrays, **kw)


@pytest.mark.parametrize("shape", [(17,), (1000, 257), (3, 5, 7)])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", list(LOCAL))
def test_local_step_ref_matches_jax_ref_and_pallas(kind, shape, case):
    arrays = _local_inputs(kind, shape, case)
    want_ref = _local(kind, JR, arrays)
    want_pallas = _local(kind, JK, arrays)
    got = _local(kind, R, _port(*arrays))
    assert got.dtype == DTYPES[CASES[case][0]][1]
    assert tuple(got.shape) == shape
    tol = _tol("scaled", CASES[case][0])
    np.testing.assert_allclose(_f32(got), _f32(want_ref), **tol)
    np.testing.assert_allclose(_f32(got), _f32(want_pallas), **tol)
    if case == "float32":
        # the scalars are rounded where the reference rounds them: bit-equal
        np.testing.assert_array_equal(_f32(got), _f32(want_ref))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", list(LOCAL))
def test_local_step_tolerances_reject_noop_and_sign_flip(kind, case):
    arrays = _local_inputs(kind, (1000, 257), case)
    want = _local(kind, JR, arrays)
    x = arrays[0]
    tol = _tol("scaled", CASES[case][0])
    flipped = (2 * x.astype(jnp.float32) - want.astype(jnp.float32)
               ).astype(x.dtype)
    for wrong in (x, flipped):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(_f32(wrong), _f32(want), **tol)


def test_prox_outer_rounds_eta_lam_once():
    """ηλ is the f64 product rounded to f32 once, as the reference's
    ``eta * lam * (w − θ)`` forms it; f32(η)·f32(λ) is another f32 for
    η = 0.01, λ = 20 and moves outputs by an ulp, which the bit-equality
    with the reference catches."""
    eta, lam = LOCAL["prox_outer"][0]["eta"], LOCAL["prox_outer"][0]["lam"]
    assert np.float32(eta * lam) != np.float32(eta) * np.float32(lam)
    w, th = _local_inputs("prox_outer", (1000, 257), "float32")
    want = np.asarray(JR.prox_outer_ref(w, th, eta, lam))
    tw, tth = _port(w, th)
    got = R.prox_outer_ref(tw, tth, eta, lam).numpy()
    np.testing.assert_array_equal(got, want)
    w32, th32 = np.asarray(w), np.asarray(th)
    twice = w32 - (np.float32(eta) * np.float32(lam)) * (w32 - th32)
    assert np.any(twice != want)


def _nested(rng, scale=1.0, dtype=np.float32):
    return {"conv": [{"b": (scale * rng.randn(3)).astype(dtype),
                      "w": (scale * rng.randn(2, 2, 3)).astype(dtype)}],
            "fc": [{"w": (scale * rng.randn(5, 4)).astype(dtype)},
                   {"b": (scale * rng.randn(7)).astype(dtype)}]}


@pytest.mark.parametrize("mode", ["ref", "auto"])
@pytest.mark.parametrize("kind", list(LOCAL))
def test_local_tree_fronts_match_reference(kind, mode):
    from repro.kernels.fused_update import ops as jops
    rng = np.random.RandomState(3)
    w, th = _nested(rng), _nested(rng)
    g = _nested(rng, scale=25.0)
    kw = LOCAL[kind][0]
    trees = {"sgd_step": (w, g), "prox_inner": (th, g, w),
             "prox_outer": (w, th)}[kind]
    want = getattr(jops, kind + "_tree")(
        *[jax_tree(t) for t in trees], **kw, mode="ref")
    got = getattr(ops, kind + "_tree")(
        *[params_from_jax(t, "cpu") for t in trees], **kw, mode=mode)
    want_leaves = jax.tree.leaves(want)
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves) == 4
    # the reference's fronts are jitted, and XLA contracts the fused
    # multiply and subtract into one FMA there: an ulp apart at most
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)
    assert all(v == 0 for v in K.LAUNCHES.values())


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
    assert K.LAUNCHES == {"sgd_step": 0, "prox_inner": 0, "prox_outer": 0,
                          "apply_scaled": 0, "apply_rows": 0,
                          "apply_rows_q": 0}


@pytest.mark.parametrize("mode", ["kernel", "seq", "bogus"])
def test_tree_fronts_refuse_kernel_on_cpu_and_unknown_modes(mode):
    w = {"a": torch.zeros(3)}
    with pytest.raises(ValueError):
        ops.apply_delta_tree(w, {"a": torch.ones(3)}, 1.0, mode=mode)
    if mode == "seq":
        # only the stacked applies take the sequential mode
        out = ops.apply_rows_tree(w, {"a": torch.ones(2, 3)},
                                  torch.tensor([0.25, 0.5]), mode=mode)
        np.testing.assert_array_equal(out["a"].numpy(),
                                      np.full(3, -0.75, np.float32))
    else:
        with pytest.raises(ValueError):
            ops.apply_rows_tree(w, {"a": torch.ones(2, 3)}, torch.ones(2),
                                mode=mode)
    for front, args in ((ops.sgd_step_tree, (w, w, 0.1)),
                        (ops.prox_inner_tree, (w, w, w, 0.1, 2.0)),
                        (ops.prox_outer_tree, (w, w, 0.1, 2.0))):
        with pytest.raises(ValueError):
            front(*args, mode=mode)


def test_wrappers_check_inputs_before_building():
    # every refusal below happens in Python, before nvcc or the card
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.apply_scaled(torch.zeros(4), torch.zeros(4), 1.0)
    # the leaf-list wrappers check every leaf before the library is loaded
    for fn in (K.apply_scaled_leaves, K.sgd_step_leaves):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn([torch.zeros(4), torch.zeros(3)],
               [torch.zeros(4), torch.zeros(3)], 0.5)
        with pytest.raises(ValueError, match="leaves"):
            fn([torch.zeros(4)], [torch.zeros(4), torch.zeros(3)], 0.5)
        with pytest.raises(TypeError, match="host number"):
            fn([torch.zeros(4)], [torch.zeros(4)], torch.tensor(0.5))
        with pytest.raises(TypeError, match="torch.Tensor"):
            fn([np.zeros(4)], [torch.zeros(4)], 0.5)
        assert fn([], [], 0.5) == []
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.apply_rows(torch.zeros(4), torch.zeros(2, 4), torch.zeros(2))
    with pytest.raises(TypeError, match="torch.Tensor"):
        K.apply_scaled(np.zeros(4), torch.zeros(4), 1.0)
    x = torch.zeros(4)
    for call in (lambda: K.sgd_step(x, x, 0.1),
                 lambda: K.prox_inner(x, x, x, 0.1, 2.0),
                 lambda: K.prox_outer(x, x, 0.1, 2.0)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    with pytest.raises(TypeError, match="torch.Tensor"):
        K.prox_inner([0.0] * 4, x, x, 0.1, 2.0)


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


# --- the leaf table of sgd_step and apply_scaled: one launch per tree ------

def _plan_trees(sizes, dtypes):
    """outputs and two input lists: leaf i has sizes[i] elements and input
    dtypes dtypes[i] (the output takes the first)."""
    ws = [torch.zeros(n, dtype=DTYPES[a][1]) for n, (a, _) in
          zip(sizes, dtypes)]
    bs = [torch.zeros(n, dtype=DTYPES[b][1]) for n, (_, b) in
          zip(sizes, dtypes)]
    return [torch.empty_like(w) for w in ws], ws, bs


F, B = "float32", "bfloat16"
PLAN_CASES = {
    "one pair": ([3, 0, 17, 1, 8192], [(F, F)] * 5),
    "mixed pairs": ([5, 7, 0, 9, 11, 13, 2],
                    [(F, F), (B, B), (F, B), (F, F), (B, B), (F, B),
                     (B, F)]),
    "long tree": ([1 + (i * 37) % 50 for i in range(101)], [(F, F)] * 101),
    "all empty": ([0, 0], [(F, F), (B, B)]),
}


@pytest.mark.parametrize("max_leaves", [1, 3, 48])
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_launches_covers_every_leaf_once(case, max_leaves):
    sizes, dtypes = PLAN_CASES[case]
    outs, ws, bs = _plan_trees(sizes, dtypes)
    plan = K.plan_launches("t", (("w", ws), ("b", bs)), outs, max_leaves)
    seen = [i for launch in plan for i in launch.leaves]
    assert sorted(seen) == [i for i, n in enumerate(sizes) if n]
    # one launch per dtype pair and chunk of max_leaves non-empty leaves
    pairs = {}
    for i, n in enumerate(sizes):
        if n:
            pairs.setdefault(dtypes[i], []).append(i)
    assert len(plan) == sum(-(-len(v) // max_leaves) for v in pairs.values())
    codes = {F: 0, B: 1}
    for launch in plan:
        assert 1 <= len(launch.leaves) <= max_leaves
        assert list(launch.leaves) == sorted(launch.leaves)
        assert all(tuple(codes[d] for d in dtypes[i]) == launch.codes
                   for i in launch.leaves)
        # per leaf: output, w, b pointers, length, vector flag
        assert len(launch.words) == 5 * len(launch.leaves)
        for j, i in enumerate(launch.leaves):
            assert list(launch.words[5 * j:5 * j + 5]) == [
                outs[i].data_ptr(), ws[i].data_ptr(), bs[i].data_ptr(),
                sizes[i], 1]
    # the pairs come in the order of their first leaf
    firsts = [launch.leaves[0] for j, launch in enumerate(plan)
              if j == 0 or plan[j - 1].codes != launch.codes]
    assert len(firsts) == len(pairs) and firsts == sorted(firsts)


@pytest.mark.parametrize("which", ["out", "w", "b"])
def test_plan_launches_flags_unaligned_leaves(which):
    # a bank row of a 10-element f32 leaf sits 40 bytes into its stack, and
    # a view one element in sits 4 bytes past a 16-byte boundary
    stack = torch.zeros(3, 10)
    buf = torch.zeros(65)
    row, shifted = stack[1], buf[1:]
    assert row.data_ptr() % 16 == 8 and shifted.data_ptr() % 16 == 4
    leaves = {"out": [torch.empty(10), torch.empty(64)],
              "w": [torch.zeros(10), torch.zeros(64)],
              "b": [torch.zeros(10), torch.zeros(64)]}
    leaves[which] = [row, shifted]
    plan = K.plan_launches("t", (("w", leaves["w"]), ("b", leaves["b"])),
                           leaves["out"], 48)
    assert len(plan) == 1 and plan[0].leaves == (0, 1)
    assert list(plan[0].words[4::5]) == [0, 0]
    aligned = K.plan_launches("t", (("w", [stack[0]]), ("b", [buf[:10]])),
                              [torch.empty(10)], 48)
    assert list(aligned[0].words[4::5]) == [1]


@pytest.mark.parametrize("bad", ["int dtype", "shape", "strided",
                                 "not a tensor", "zero-size int dtype"])
def test_plan_launches_refuses_a_bad_leaf(bad):
    # the planner checks every input leaf in its one pass, empty ones too
    ws = [torch.zeros(4), torch.zeros(6, 2), torch.zeros(0)]
    bs = [torch.zeros(4), torch.zeros(6, 2), torch.zeros(0)]
    outs = [torch.empty_like(w) for w in ws]
    assert len(K.plan_launches("t", (("w", ws), ("b", bs)), outs, 48)) == 1
    bs[1] = {"int dtype": torch.zeros(6, 2, dtype=torch.int32),
             "shape": torch.zeros(12),
             "strided": torch.zeros(2, 6).t(),
             "not a tensor": np.zeros((6, 2), np.float32),
             "zero-size int dtype": torch.zeros(6, 2)}[bad]
    if bad == "zero-size int dtype":
        bs[2] = torch.zeros(0, dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        K.plan_launches("t", (("w", ws), ("b", bs)), outs, 48)


@pytest.mark.parametrize("n, vec", [(10, 0), (8, 1), (12, 1), (9, 0)])
def test_plan_launches_flags_stacks_by_row_stride(n, vec):
    # every row of a stack is aligned only if the row stride, n f32
    # elements, is a multiple of 16 bytes: the MNIST CNN's last bias (10
    # elements, 40-byte rows) moves element by element although the stack's
    # base is aligned, an 8-element leaf in vectors
    w, stack, out = torch.zeros(n), torch.zeros(5, n), torch.empty(n)
    assert w.data_ptr() % 16 == 0 and stack.data_ptr() % 16 == 0
    plan = K.plan_launches("t", (("w", [w]), ("d", [stack])), [out], 48,
                           rows=5)
    assert len(plan) == 1 and plan[0].leaves == (0,)
    assert list(plan[0].words) == [out.data_ptr(), w.data_ptr(),
                                   stack.data_ptr(), n, vec]
    # a bf16 stack halves the row stride: 8 bf16 elements are 16 bytes
    half = K.plan_launches("t", (("w", [w]), ("d", [stack.bfloat16()])),
                           [out], 48, rows=5)
    assert half[0].codes == (0, 1)
    assert half[0].words[4] == int(n % 8 == 0)


@pytest.mark.parametrize("bad", ["rows", "trailing shape", "no row axis",
                                 "rank"])
def test_plan_launches_refuses_a_bad_stack(bad):
    ws = [torch.zeros(4), torch.zeros(6, 2), torch.zeros(0)]
    stacks = [torch.zeros(3, 4), torch.zeros(3, 6, 2), torch.zeros(3, 0)]
    outs = [torch.empty_like(w) for w in ws]
    args = (("w", ws), ("d", stacks))
    plan = K.plan_launches("t", args, outs, 48, rows=3)
    assert [launch.leaves for launch in plan] == [(0, 1)]
    # an M = 0 stack of each leaf plans the same launch
    empty = [torch.zeros(0, *w.shape) for w in ws]
    plan = K.plan_launches("t", (("w", ws), ("d", empty)), outs, 48, rows=0)
    assert [launch.leaves for launch in plan] == [(0, 1)]
    stacks[1] = {"rows": torch.zeros(2, 6, 2),
                 "trailing shape": torch.zeros(3, 12),
                 "no row axis": torch.zeros(6, 2),
                 "rank": torch.zeros(3, 1, 6, 2)}[bad]
    with pytest.raises(ValueError):
        K.plan_launches("t", args, outs, 48, rows=3)
    # an empty leaf's stack is checked too
    stacks[1] = torch.zeros(3, 6, 2)
    stacks[2] = torch.zeros(2, 0)
    with pytest.raises(ValueError):
        K.plan_launches("t", args, outs, 48, rows=3)


# --- the q-stack table of apply_rows_q and the three-input prox_inner table -

def _q_table(sizes, w_dtypes, m=4):
    """outputs, w leaves of sizes[i] elements and dtype w_dtypes[i], their
    int8 [m, n] stacks and their [m] f32 scales."""
    ws = [torch.zeros(n, dtype=DTYPES[d][1]) for n, d in zip(sizes, w_dtypes)]
    qs = [torch.zeros(m, n, dtype=torch.int8) for n in sizes]
    scales = [torch.zeros(m) for _ in sizes]
    return [torch.empty_like(w) for w in ws], ws, qs, scales


@pytest.mark.parametrize("max_leaves", [1, 3, 48])
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_launches_q_stack_covers_every_leaf_once(case, max_leaves):
    # the w dtype of PLAN_CASES' first input; the stack is int8 and the
    # scales f32 for every leaf, so one launch per w dtype and chunk
    sizes, dtypes = PLAN_CASES[case]
    w_dtypes = [a for a, _ in dtypes]
    outs, ws, qs, scales = _q_table(sizes, w_dtypes)
    args = (("w", ws), ("q_stack", qs), ("scales", scales))
    plan = K.plan_launches("t", args, outs, max_leaves, rows=4)
    seen = [i for launch in plan for i in launch.leaves]
    assert sorted(seen) == [i for i, n in enumerate(sizes) if n]
    per_dtype = collections.Counter(d for d, n in zip(w_dtypes, sizes) if n)
    assert len(plan) == sum(-(-c // max_leaves) for c in per_dtype.values())
    codes = {F: 0, B: 1}
    for launch in plan:
        assert 1 <= len(launch.leaves) <= max_leaves
        # w's code, int8's, f32's
        assert launch.codes == (codes[w_dtypes[launch.leaves[0]]], 2, 0)
        # per leaf: output, w, q, scales pointers, length, vector flag (out
        # and w are aligned; the int8 rows do not count)
        assert len(launch.words) == 6 * len(launch.leaves)
        for j, i in enumerate(launch.leaves):
            assert list(launch.words[6 * j:6 * j + 6]) == [
                outs[i].data_ptr(), ws[i].data_ptr(), qs[i].data_ptr(),
                scales[i].data_ptr(), sizes[i], 1]


@pytest.mark.parametrize("n", [16, 32, 10, 9])
def test_plan_launches_flags_q_stacks_by_w_and_out_alone(n):
    # an int8 row is n bytes, 16-byte aligned only where 16 divides n; the
    # kernel reads the rows as aligned words and shifts the codes into
    # place, so neither the row stride, nor the stack's start, nor the
    # scales' pointer clears the flag: only out and w do.  An f32 stack of
    # the same rows keeps its row-stride rule
    outs, ws, qs, scales = _q_table([n], [F], m=5)
    odd_q = torch.zeros(5 * n + 3, dtype=torch.int8)[3:].view(5, n)
    odd_scales = torch.zeros(6)[1:]
    odd_w = torch.zeros(n + 1)[1:]
    assert odd_q.data_ptr() % 16 == 3 and odd_scales.data_ptr() % 16 == 4
    for q, sc, w, vec in ((qs[0], scales[0], ws[0], 1),
                          (odd_q, odd_scales, ws[0], 1),
                          (qs[0], scales[0], odd_w, 0)):
        plan = K.plan_launches("t", (("w", [w]), ("q_stack", [q]),
                                     ("scales", [sc])), outs, 48, rows=5)
        assert len(plan) == 1 and plan[0].leaves == (0,)
        assert plan[0].codes == (0, 2, 0)
        assert plan[0].words[5] == vec
    f32 = K.plan_launches("t", (("w", ws), ("d", [qs[0].float()])), outs,
                          48, rows=5)
    assert f32[0].words[4] == int(n % 4 == 0)


@pytest.mark.parametrize("bad", ["int8 w", "int8 scales", "f32 scales "
                                 "too long", "bf16 scales", "scales [M, 1]",
                                 "int32 stack"])
def test_plan_launches_takes_int8_only_as_the_stack(bad):
    outs, ws, qs, scales = _q_table([4, 12, 0], [F, F, F], m=3)
    args = (("w", ws), ("q_stack", qs), ("scales", scales))
    assert [launch.leaves for launch in
            K.plan_launches("t", args, outs, 48, rows=3)] == [(0, 1)]
    i = 2 if bad == "f32 scales too long" else 1
    if bad == "int8 w":
        ws[i] = torch.zeros(12, dtype=torch.int8)
    elif bad == "int32 stack":
        qs[i] = torch.zeros(3, 12, dtype=torch.int32)
    else:
        scales[i] = {"int8 scales": torch.zeros(3, dtype=torch.int8),
                     "f32 scales too long": torch.zeros(4),
                     "bf16 scales": torch.zeros(3, dtype=torch.bfloat16),
                     "scales [M, 1]": torch.zeros(3, 1)}[bad]
    # the message names the leaf, an empty one too, and what is wrong
    want = {"int8 w": r"w\[1\] has dtype torch.int8; the kernel takes "
                      r"float32 or bfloat16$",
            "int32 stack": r"q_stack\[1\] has dtype torch.int32; the kernel "
                           r"takes float32 or bfloat16 or int8$",
            "int8 scales": r"scales\[1\] has dtype torch.int8; the kernel "
                           r"takes float32$",
            "bf16 scales": r"scales\[1\] has dtype torch.bfloat16",
            "f32 scales too long": r"scales\[2\] has shape \(4,\), "
                                   r"expected \(3,\)",
            "scales [M, 1]": r"scales\[1\] has shape \(3, 1\)"}[bad]
    with pytest.raises((TypeError, ValueError), match=want):
        K.plan_launches("t", args, outs, 48, rows=3)
    # without rows there is no stack position, and without scales an int8
    # stack means nothing: an int8 input is refused
    with pytest.raises(TypeError, match="float32 or bfloat16$"):
        K.plan_launches("t", (("w", ws[:1]), ("b", [qs[0][0]])), outs[:1], 48)
    with pytest.raises(TypeError, match=r"d\[0\] has dtype torch.int8; the "
                                        r"kernel takes float32 or bfloat16$"):
        K.plan_launches("t", (("w", ws[:1]), ("d", qs[:1])), outs[:1], 48,
                        rows=3)


PROX_INNER_PLAN = {
    "one triple": ([3, 0, 17, 1, 8192], [(F, F, F)] * 5),
    "mixed triples": ([5, 7, 0, 9, 11, 13, 2, 6, 4],
                      [(F, F, F), (B, B, B), (F, B, B), (F, F, F),
                       (F, B, F), (B, F, B), (F, B, B), (B, B, F),
                       (B, B, B)]),
    "long tree": ([1 + (i * 37) % 50 for i in range(101)], [(F, B, F)] * 101),
}


@pytest.mark.parametrize("max_leaves", [1, 3, 48])
@pytest.mark.parametrize("case", list(PROX_INNER_PLAN))
def test_plan_launches_three_inputs_cover_every_leaf_once(case, max_leaves):
    sizes, dtypes = PROX_INNER_PLAN[case]
    trees = [[torch.zeros(n, dtype=DTYPES[d[k]][1])
              for n, d in zip(sizes, dtypes)] for k in range(3)]
    outs = [torch.empty_like(t) for t in trees[0]]
    args = tuple(zip(("theta", "g", "w"), trees))
    plan = K.plan_launches("t", args, outs, max_leaves)
    seen = [i for launch in plan for i in launch.leaves]
    assert sorted(seen) == [i for i, n in enumerate(sizes) if n]
    triples = collections.Counter(d for d, n in zip(dtypes, sizes) if n)
    assert len(plan) == sum(-(-c // max_leaves) for c in triples.values())
    codes = {F: 0, B: 1}
    for launch in plan:
        assert list(launch.leaves) == sorted(launch.leaves)
        assert all(tuple(codes[d] for d in dtypes[i]) == launch.codes
                   for i in launch.leaves)
        assert len(launch.words) == 6 * len(launch.leaves)
        for j, i in enumerate(launch.leaves):
            assert list(launch.words[6 * j:6 * j + 6]) == [
                outs[i].data_ptr(), *(t[i].data_ptr() for t in trees),
                sizes[i], 1]
    # a misaligned w (a view 4 bytes in) clears the leaf's flag alone
    trees[2][0] = torch.zeros(sizes[0] + 1, dtype=trees[2][0].dtype)[1:]
    plan = K.plan_launches("t", args, outs, 48)
    flags = {i: launch.words[6 * j + 5] for launch in plan
             for j, i in enumerate(launch.leaves)}
    assert flags[0] == int(trees[2][0].data_ptr() % 16 == 0)
    assert all(flags[i] == 1 for i in flags if i)


# each table front as a function of (w tree, other tree), and how the other
# tree is built from a w-shaped tree (apply_rows: a 2-row stack per leaf;
# apply_rows_q: a 2-row int8 stack and its scales per leaf)
TABLE_FRONTS = {
    "sgd_step": (lambda w, b, mode: ops.sgd_step_tree(w, b, 0.5, mode=mode),
                 lambda t: t),
    "apply_scaled": (lambda w, b, mode: ops.apply_delta_tree(w, b, 0.5,
                                                             mode=mode),
                     lambda t: t),
    "prox_outer": (lambda w, b, mode: ops.prox_outer_tree(w, b, 0.1, 2.0,
                                                          mode=mode),
                   lambda t: t),
    "apply_rows": (lambda w, b, mode: ops.apply_rows_tree(
        w, b, torch.ones(2), mode=mode),
        lambda t: {"a": torch.stack([t["a"]] * 2),
                   "b": [torch.stack([t["b"][0]] * 2)]}),
    "prox_inner": (lambda w, b, mode: ops.prox_inner_tree(w, b, b, 0.1, 2.0,
                                                          mode=mode),
                   lambda t: t),
    "apply_rows_q": (lambda w, b, mode: ops.apply_rows_q_tree(
        w, b[0], b[1], torch.full((2,), 0.5), mode=mode),
        lambda t: ({"a": torch.stack([t["a"]] * 2).to(torch.int8),
                    "b": [torch.stack([t["b"][0]] * 2).to(torch.int8)]},
                   {"a": torch.full((2,), 0.25, device=t["a"].device),
                    "b": [torch.full((2,), 0.25, device=t["b"][0].device)]})),
}


@pytest.mark.parametrize("kind", list(TABLE_FRONTS))
def test_table_fronts_auto_on_cpu_take_the_plain_version(kind, monkeypatch):
    front, other = TABLE_FRONTS[kind]

    def no_build():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(K, "_lib", no_build)
    rng = np.random.RandomState(3)
    w = {"a": torch.from_numpy(rng.randn(3).astype(np.float32)),
         "b": [torch.from_numpy(rng.randn(2, 2).astype(np.float32))]}
    b = other({"a": torch.from_numpy(rng.randn(3).astype(np.float32) * 4),
               "b": [torch.from_numpy(
                   rng.randn(2, 2).astype(np.float32) * 4)]})
    got, want = front(w, b, "auto"), front(w, b, "ref")
    for x, y, w0 in zip(tree_leaves(got), tree_leaves(want), tree_leaves(w)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert not torch.equal(x, w0)
    assert all(v == 0 for v in K.LAUNCHES.values())


@pytest.mark.parametrize("kind", list(TABLE_FRONTS))
def test_table_fronts_refuse_kernel_on_cpu_and_mixed_devices(kind, monkeypatch):
    front, other = TABLE_FRONTS[kind]

    def no_build():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(K, "_lib", no_build)
    cpu = {"a": torch.zeros(3), "b": [torch.zeros(2, 2)]}
    with pytest.raises(ValueError, match="CUDA tensors only"):
        front(cpu, other(cpu), mode="kernel")
    mixed = {"a": torch.zeros(3), "b": [torch.zeros(2, 2, device="meta")]}
    with pytest.raises(ValueError, match="several devices"):
        front(mixed, other(mixed), mode="auto")
    # the kernel's wrapper refuses every leaf off the first one's card
    with pytest.raises(ValueError, match="CUDA tensors only"):
        front(mixed, other(mixed), mode="kernel")
    assert all(v == 0 for v in K.LAUNCHES.values())


@pytest.mark.parametrize("mode", ["ref", "auto"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_delta_tree_matches_reference(case, mode):
    from repro.kernels.fused_update import ops as jops
    w_dt, d_dt = (DTYPES[d][0] for d in CASES[case])
    rng = np.random.RandomState(5)
    w = jax.tree.map(lambda x: jnp.asarray(x, w_dt), _nested(rng))
    d = jax.tree.map(lambda x: jnp.asarray(x, d_dt), _nested(rng))
    want = jops.apply_delta_tree(w, d, 0.37, mode="ref")
    got = ops.apply_delta_tree(params_from_jax(w, "cpu"),
                               params_from_jax(d, "cpu"), 0.37, mode=mode)
    want_leaves, got_leaves = jax.tree.leaves(want), tree_leaves(got)
    assert len(got_leaves) == len(want_leaves) == 4
    tol = _tol("scaled", CASES[case][0])
    # jitted on XLA:CPU the reference may contract w − s·Δ into one FMA
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == DTYPES[CASES[case][0]][1]
        np.testing.assert_allclose(_f32(a), _f32(b), **tol)


def test_tree_unflatten_keeps_structure():
    from repro_torch.core.quant import QuantStack
    tree = {"b": [1, None, (2, 3)], "a": QuantStack(4, 5)}
    leaves = tree_leaves(tree)
    assert leaves == [4, 5, 1, 2, 3]
    out = tree_unflatten(tree, [x * 10 for x in leaves])
    assert out == {"a": QuantStack(40, 50), "b": [10, None, (20, 30)]}
    assert isinstance(out["a"], QuantStack) and isinstance(out["b"][2], tuple)
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(tree, leaves + [6])


def _nested_with_bias(rng, dtype=np.float32, rows=None):
    """``_nested`` with a 10-element leaf beside it (the MNIST CNN's last
    bias, whose f32 rows are 40 bytes); with ``rows`` each leaf is a stack
    of that many rows."""
    lead = () if rows is None else (rows,)
    tree = jax.tree.map(
        lambda x: rng.randn(*lead, *x.shape).astype(dtype), _nested(rng))
    tree["head"] = rng.randn(*lead, 10).astype(dtype)
    return tree


@pytest.mark.parametrize("mode", ["ref", "auto"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["prox_outer", "apply_rows"])
def test_table_tree_fronts_match_reference(kind, case, mode):
    """The fronts that now launch once per tree, against the JAX package's
    fronts on a nested tree with a 10-element leaf, in every dtype case."""
    from repro.kernels.fused_update import ops as jops
    w_dt, o_dt = CASES[case]
    rng = np.random.RandomState(7)
    w = _nested_with_bias(rng)
    if kind == "prox_outer":
        other = _nested_with_bias(rng)
        kw = LOCAL["prox_outer"][0]
        scalars = (kw["eta"], kw["lam"])
        tol = _tol("scaled", w_dt)
        jfront, front = jops.prox_outer_tree, ops.prox_outer_tree
    else:
        m = 6
        other = _nested_with_bias(rng, rows=m)
        weights = (rng.rand(m) / np.sqrt(m)).astype(np.float32)
        weights[1::3] = 0.0
        scalars = None
        tol = _tol("rows", w_dt)
        jfront, front = jops.apply_rows_tree, ops.apply_rows_tree
    jw = jax.tree.map(lambda x: jnp.asarray(x, DTYPES[w_dt][0]), w)
    jo = jax.tree.map(lambda x: jnp.asarray(x, DTYPES[o_dt][0]), other)
    tw, to = params_from_jax(jw, "cpu"), params_from_jax(jo, "cpu")
    if scalars is None:
        want = jfront(jw, jo, jnp.asarray(weights), mode="ref")
        got = front(tw, to, torch.from_numpy(weights), mode=mode)
    else:
        want = jfront(jw, jo, *scalars, mode="ref")
        got = front(tw, to, *scalars, mode=mode)
    want_leaves, got_leaves = jax.tree.leaves(want), tree_leaves(got)
    assert len(got_leaves) == len(want_leaves) == 5
    # jitted on XLA:CPU the reference may contract a multiply and a
    # subtraction into one FMA, and sums the rows in its own order
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == DTYPES[w_dt][1]
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_f32(a), _f32(b), **tol)
    assert all(v == 0 for v in K.LAUNCHES.values())
