"""Port of int8 delta banking (``repro_torch.core.quant``), the
``apply_rows_q`` kernel's plain version and the serving half of
``repro_torch.core.server`` against the JAX package on the same numpy
inputs.

Tolerances: f32 outputs atol 1e-5 / rtol 1e-4 (the stacked reductions sum
their M rows in other orders); bf16 outputs rtol 2^-7 / atol 1e-5, about one
bf16 ulp.  The inputs make the update of the order of ``w`` so that a no-op
or a sign-flipped apply fails these limits
(``test_apply_rows_q_tolerances_reject_noop_and_sign_flip``).

Codes: ``quantize_stack`` divides by the scale and rounds half to even in
both packages, so codes must be equal.  Where the two divisions round
``x / scale`` to different sides of a half-integer, a code may differ by one:
every mismatch must be such an exact tie (``x / scale`` within 1e-6 of
k + 1/2 in float64) and a ±1, and the tests count them rather than tolerate
them silently.  Scales are absmax/127 in f32 in both and must be bit-equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core import server as jserver
from repro.core.subset import SubsetSpec as JSubsetSpec
from repro.core.subset import merge_subset as j_merge_subset
from repro.core.types import ServerState as JServerState
from repro.kernels.fused_update import kernel as JK
from repro.kernels.fused_update import ref as JR
from repro_torch.convert import params_from_jax
from repro_torch.core import quant as tq
from repro_torch.core import server as tserver
from repro_torch.core.subset import (SubsetSpec, leaf_paths, merge_subset,
                                     row_nbytes, subset_like, tree_nbytes)
from repro_torch.core.types import ServerState
from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.fused_update import ops
from repro_torch.kernels.fused_update import ref as R
from repro_torch.tree import tree_leaves, tree_map

ROWS_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)
N = 8192 + 5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(x):
    """A numpy or JAX array as a CPU tensor (bf16 by its bits)."""
    return params_from_jax(np.asarray(x), "cpu")


def _q_inputs(m, w_dtype, n=N):
    """w, int8 codes over the full range, scales of order 1/127 and weights
    rand/sqrt(M); every third row is a padding row (weight 0, scale 0)."""
    rng = np.random.RandomState(m)
    w = jnp.asarray(0.5 * rng.randn(n), DTYPES[w_dtype][0])
    q = rng.randint(-127, 128, size=(m, n)).astype(np.int8)
    scales = ((0.5 + rng.rand(m)) / 127.0).astype(np.float32)
    weights = (rng.rand(m) / np.sqrt(m)).astype(np.float32)
    weights[1::3] = 0.0
    scales[1::3] = 0.0
    return w, q, scales, weights


@pytest.mark.parametrize("m", [1, 3, 8, 128, 300])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_apply_rows_q_ref_matches_jax_ref_and_pallas(m, w_dtype):
    w, q, scales, weights = _q_inputs(m, w_dtype)
    want_ref = JR.apply_rows_q_ref(w, q, scales, weights)
    got = R.apply_rows_q_ref(_t(w), torch.from_numpy(q),
                             torch.from_numpy(scales),
                             torch.from_numpy(weights))
    assert got.dtype == DTYPES[w_dtype][1] and tuple(got.shape) == (N,)
    tol = BF16_TOL if w_dtype == "bfloat16" else ROWS_TOL
    np.testing.assert_allclose(_f32(got), _f32(want_ref), **tol)
    if w_dtype == "bfloat16" and m > JK.ROW_BLOCK:
        # the Pallas kernel rounds its partial sum to bf16 between 128-row
        # chunks (kernel.py:168-184); the plain versions and the port's
        # kernel keep the sum in f32, so only the ref computes the same
        # function here
        return
    want_pallas = JK.apply_rows_q(w, jnp.asarray(q), scales, weights,
                                  interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want_pallas), **tol)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_apply_rows_q_tolerances_reject_noop_and_sign_flip(w_dtype):
    w, q, scales, weights = _q_inputs(300, w_dtype)
    want = JR.apply_rows_q_ref(w, q, scales, weights)
    tol = BF16_TOL if w_dtype == "bfloat16" else ROWS_TOL
    flipped = (2 * w.astype(jnp.float32) - want.astype(jnp.float32)
               ).astype(w.dtype)
    for wrong in (w, flipped):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(_f32(wrong), _f32(want), **tol)


def test_apply_rows_q_wrapper_checks_inputs_before_building():
    w, q = torch.zeros(4), torch.zeros(2, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.apply_rows_q(w, q, torch.zeros(2), torch.zeros(2))
    with pytest.raises(TypeError, match="torch.Tensor"):
        K.apply_rows_q(np.zeros(4), q, torch.zeros(2), torch.zeros(2))
    assert K.LAUNCHES["apply_rows_q"] == 0
    with pytest.raises(ValueError):
        ops.apply_rows_q_tree({"a": w}, {"a": q}, {"a": torch.zeros(2)},
                              torch.zeros(2), mode="kernel")


# the MNIST CNN's 8 leaves (configs/paper_models.py MNIST_CNN), the tree a
# served int8 window applies
CNN_SHAPES = {"conv": [{"b": (8,), "w": (3, 3, 1, 8)},
                       {"b": (16,), "w": (3, 3, 8, 16)}],
              "fc": [{"b": (64,), "w": (784, 64)},
                     {"b": (10,), "w": (64, 10)}]}


@functools.lru_cache(maxsize=None)
def _cnn_q_case(w_dtype):
    """w, int8 stacks and each leaf's own row scales over the CNN's leaves,
    the shared weights (M = 8, padding rows of weight 0 and scale 0), and
    per leaf the JAX package's ``apply_rows_q`` through its ref and its
    Pallas kernel in interpret mode."""
    m = 8
    rng = np.random.RandomState(11)
    shapes = jax.tree.leaves(CNN_SHAPES, is_leaf=lambda x: isinstance(x,
                                                                      tuple))
    jdt = DTYPES[w_dtype][0]
    ws = [jnp.asarray(0.5 * rng.randn(*sh), jdt) for sh in shapes]
    qs = [rng.randint(-127, 128, size=(m, *sh)).astype(np.int8)
          for sh in shapes]
    scales = [((0.5 + rng.rand(m)) / 127.0).astype(np.float32)
              for _ in shapes]
    weights = (rng.rand(m) / np.sqrt(m)).astype(np.float32)
    weights[1::3] = 0.0
    for sc in scales:
        sc[1::3] = 0.0
    wants = [(JR.apply_rows_q_ref(w, q, sc, weights),
              JK.apply_rows_q(w, jnp.asarray(q), sc, weights,
                              interpret=True))
             for w, q, sc in zip(ws, qs, scales)]
    return ws, qs, scales, weights, wants


@pytest.mark.parametrize("mode", ["auto", "ref"])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_apply_rows_q_tree_matches_jax_on_cnn_leaves(w_dtype, mode):
    """``apply_rows_q_tree`` (one launch per tree on the card, the plain
    version here) against the JAX package's ``apply_rows_q`` leaf by leaf:
    its ref and its Pallas kernel in interpret mode."""
    ws, qs, scales, weights, wants = _cnn_q_case(w_dtype)
    tw = {f"{i}": _t(w) for i, w in enumerate(ws)}
    tqs = {f"{i}": torch.from_numpy(q) for i, q in enumerate(qs)}
    tsc = {f"{i}": torch.from_numpy(sc) for i, sc in enumerate(scales)}
    got = ops.apply_rows_q_tree(tw, tqs, tsc, torch.from_numpy(weights),
                                mode=mode)
    tol = BF16_TOL if w_dtype == "bfloat16" else ROWS_TOL
    for i, (w, q, want) in enumerate(zip(ws, qs, wants)):
        leaf = got[f"{i}"]
        assert leaf.dtype == DTYPES[w_dtype][1] and leaf.shape == w.shape
        for one in want:
            np.testing.assert_allclose(_f32(leaf), _f32(one), **tol)
        # the leaf's own scales: another leaf's would not do
        other = JR.apply_rows_q_ref(w, q, scales[(i + 1) % len(scales)],
                                    weights)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(_f32(leaf), _f32(other), **tol)
    assert K.LAUNCHES["apply_rows_q"] == 0


# -- quantization ---------------------------------------------------------

def _stack_tree(seed, cap=6):
    rng = np.random.RandomState(seed)
    t = {"conv": [{"b": rng.randn(cap, 8), "w": rng.randn(cap, 3, 3, 1, 8)}],
         "fc": [{"b": rng.randn(cap, 10), "w": 0.01 * rng.randn(cap, 16, 10)}]}
    t = jax.tree.map(lambda x: x.astype(np.float32), t)
    t["fc"][0]["b"][2] = 0.0          # an all-zero row: scale 0, exact
    return t


def _assert_codes(got, want, x32, scale):
    """Equal codes, or ±1 at an exact tie of x / scale; returns the count
    of such ties."""
    got = got.numpy().astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    bad = got != want
    if not bad.any():
        return 0
    ratio = (np.asarray(x32, np.float64)
             / np.where(scale > 0, scale, 1.0).astype(np.float64))[bad]
    assert np.all(np.abs(got[bad] - want[bad]) == 1)
    assert np.all(np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) < 1e-6), \
        "a code differs away from a rounding tie"
    return int(bad.sum())


def _check_stack(tq_stack, jq_stack, src):
    ties = 0
    for g, w, s, js, x in zip(tree_leaves(tq_stack.q),
                              jax.tree.leaves(jq_stack.q),
                              tree_leaves(tq_stack.scales),
                              jax.tree.leaves(jq_stack.scales),
                              jax.tree.leaves(src)):
        assert g.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        bshape = (-1,) + (1,) * (x.ndim - 1)
        ties += _assert_codes(g, w, np.asarray(x, np.float32),
                              np.asarray(js).reshape(bshape))
    return ties


def test_fma_err_in_column_blocks_is_bit_equal(monkeypatch):
    """A leaf larger than ``_BLOCK_ELEMS`` is quantized in column blocks
    (row absmax, codes, the FMA error and the residual's codes, with and
    without a carried residual), with the same bits as in one pass; a
    1-d stack too."""
    rs = np.random.RandomState(0)
    raw = {"x": torch.from_numpy((rs.randn(3, 5, 7) * 1e-3)
                                 .astype(np.float32)),
           "y": torch.from_numpy(rs.randn(3).astype(np.float32))}
    res = tree_map(lambda x: 0.3 * torch.from_numpy(
        rs.randn(*x.shape).astype(np.float32)) * x.abs().max(), raw)
    for residual in (None, res):
        whole = tq.ef_quantize_stack(raw, residual)
        with monkeypatch.context() as m:
            m.setattr(tq, "_BLOCK_ELEMS", 8)
            blocked = tq.ef_quantize_stack(raw, residual)
        for a, b in zip(tree_leaves(blocked), tree_leaves(whole)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        # the residual codes are not all zero: the error moved
        assert bool((whole[1].q["x"] != 0).any())
    with monkeypatch.context() as m:
        m.setattr(tq, "_BLOCK_ELEMS", 4)
        blocked = tq.quantize_stack(raw)
    for a, b in zip(tree_leaves(blocked),
                    tree_leaves(tq.quantize_stack(raw))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_stack_codes_and_scales_match_jax(seed):
    raw = _stack_tree(seed)
    ties = _check_stack(tq.quantize_stack(params_from_jax(raw, "cpu")),
                        jq.quantize_stack(raw), raw)
    assert ties <= 2, f"{ties} codes differ at ties"
    back = tq.dequantize_stack(tq.quantize_stack(params_from_jax(raw, "cpu")))
    want = jq.dequantize_stack(jq.quantize_stack(raw))
    for a, b in zip(tree_leaves(back), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=float(np.abs(b).max()) / 127 + 1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_ef_quantize_stack_codes_and_scales_match_jax(seed):
    raw = _stack_tree(seed)
    res = jax.tree.map(lambda x: (0.004 * np.random.RandomState(seed + 9)
                                  .randn(*x.shape)).astype(np.float32), raw)
    for residual in (None, res):
        jd, jr = jq.ef_quantize_stack(raw, residual)
        td, tr = tq.ef_quantize_stack(
            params_from_jax(raw, "cpu"),
            None if residual is None else params_from_jax(residual, "cpu"))
        adj = raw if residual is None else jax.tree.map(np.add, raw, res)
        ties = _check_stack(td, jd, adj)
        # the residual codes quantize adj - dequant(codes): equal wherever
        # the delta codes were
        if ties == 0:
            err = jax.tree.map(
                lambda a, d: np.asarray(a, np.float32) - np.asarray(d),
                adj, jq.dequantize_stack(jd))
            assert _check_stack(tr, jr, err) <= 2
        assert ties <= 2


def test_quantize_tree_and_lazy_handles_match_jax():
    rng = np.random.RandomState(3)
    snap = {"fc": [None, {"b": rng.randn(10).astype(np.float32),
                          "w": rng.randn(16, 10).astype(np.float32)}]}
    jt, tt = jq.quantize_tree(snap), tq.quantize_tree(
        params_from_jax(snap, "cpu"))
    for a, b in zip(tree_leaves(tt.q), jax.tree.leaves(jt.q)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(tt.scales), jax.tree.leaves(jt.scales)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(tq.dequantize_tree(tt)),
                    jax.tree.leaves(jq.dequantize_tree(jt))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    stack = jax.tree.map(lambda x: (0.01 * rng.randn(4, *x.shape)).astype(
        np.float32), snap)
    jqs, tqs = jq.quantize_stack(stack), tq.quantize_stack(
        params_from_jax(stack, "cpu"))
    jbank, tbank = jq.QuantizedBank(jqs, 3), tq.QuantizedBank(tqs, 3)
    assert tbank.capacity == 4 and len(tbank) == 3
    jheads = jq.QuantizedHeads(snap, jbank)
    theads = tq.QuantizedHeads(params_from_jax(snap, "cpu"), tbank)
    for got, want in ((tbank.rows([2, 0]), jbank.rows([2, 0])),
                      (theads.rows([1, 2]), jheads.rows([1, 2])),
                      (theads.row(0), jheads.row(0))):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)
    assert tq.fp32_row_nbytes(tqs) == jq.fp32_row_nbytes(jqs) == 4 * 170
    assert row_nbytes(tqs) == 170 + 8


# -- subset spec ----------------------------------------------------------

def test_subset_spec_matches_jax():
    rng = np.random.RandomState(0)
    tree = {"conv": [{"b": rng.randn(2), "w": rng.randn(2, 2)}],
            "fc": [{"b": rng.randn(3), "w": rng.randn(2, 3)},
                   {"b": rng.randn(4), "w": rng.randn(3, 4)}]}
    for spelling in ("fc/#1", ("fc/#1/w", "conv"), "fc",
                     {"conv": [{"b": True, "w": False}],
                      "fc": [{"b": False, "w": False},
                             {"b": False, "w": True}]}):
        js, ts = JSubsetSpec.resolve(spelling, tree), \
            SubsetSpec.resolve(spelling, tree)
        assert ts.prefixes == js.prefixes
        assert ts.descriptor(tree) == js.descriptor(tree)
        assert ts.mask(tree) == js.mask(tree)
        jsub, tsub = js.extract(tree), ts.extract(tree)
        assert leaf_paths(tsub) == leaf_paths(jsub) == ts.validate(tree)
        assert jax.tree.structure(jsub) == jax.tree.structure(tsub)
        merged = merge_subset(tree, jax.tree.map(lambda x: -x, tsub))
        jmerged = j_merge_subset(tree, jax.tree.map(lambda x: -x, jsub))
        for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(jmerged)):
            np.testing.assert_array_equal(a, b)
        assert leaf_paths(subset_like(tree, tsub)) == leaf_paths(tsub)
    assert tree_nbytes(params_from_jax(tree, "cpu")) == 8 * 31
    with pytest.raises(ValueError, match="matches no param leaf"):
        SubsetSpec.resolve("fc/#2", tree)
    with pytest.raises(ValueError):
        SubsetSpec.resolve((), tree)


# -- the serving apply and the robust half --------------------------------

def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc": [{"b": (0.5 * rng.randn(6)).astype(np.float32),
                    "w": (0.5 * rng.randn(5, 6)).astype(np.float32)},
                   {"b": (0.5 * rng.randn(4)).astype(np.float32),
                    "w": (0.5 * rng.randn(6, 4)).astype(np.float32)}]}


def _j_state(params):
    return JServerState(params=jax.tree.map(jnp.asarray, params),
                        t=jnp.int32(3), staleness_sum=jnp.float32(1.5),
                        staleness_max=jnp.int32(1))


def _t_state(params):
    return ServerState(params=params_from_jax(params, "cpu"), t=np.int32(3),
                       staleness_sum=np.float32(1.5),
                       staleness_max=np.int32(1))


@pytest.mark.parametrize("subset", [None, "fc/#1"])
@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_apply_admitted_rows_matches_jax(subset, codec):
    params = _params()
    rng = np.random.RandomState(7)
    tree = params if subset is None \
        else JSubsetSpec.resolve(subset).extract(params)
    stack = jax.tree.map(lambda x: rng.randn(8, *x.shape).astype(np.float32),
                         tree)
    weights = (rng.rand(8) / np.sqrt(8)).astype(np.float32)
    weights[5:] = 0.0
    jstack = jq.quantize_stack(stack) if codec == "int8" else stack
    tstack = tq.quantize_stack(params_from_jax(stack, "cpu")) \
        if codec == "int8" else params_from_jax(stack, "cpu")
    want = jserver.apply_admitted_rows(_j_state(params), jstack, weights, 5,
                                       staleness_max=2, staleness_sum=3.0)
    ts = _t_state(params)
    got = tserver.apply_admitted_rows(ts, tstack, weights, 5,
                                      staleness_max=2, staleness_sum=3.0,
                                      order=list(range(8)))
    assert (int(got.t), float(got.staleness_sum), int(got.staleness_max)) \
        == (int(want.t), float(want.staleness_sum), int(want.staleness_max))
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ROWS_TOL)
    if subset is not None:
        # the backbone passes through as the same tensors
        assert got.params["fc"][0]["w"] is ts.params["fc"][0]["w"]
        assert got.params["fc"][0]["b"] is ts.params["fc"][0]["b"]
    # the incoming state is left as it was (the ring keeps it as a snapshot)
    np.testing.assert_array_equal(ts.params["fc"][1]["w"].numpy(),
                                  params["fc"][1]["w"])


def _bank_stack(seed, codec):
    rng = np.random.RandomState(seed)
    stack = jax.tree.map(lambda x: rng.randn(8, *x.shape).astype(np.float32),
                         _params())
    # row norms spread well apart: no tie at the median or the clip bound
    scale = np.array([1, 2, 3, 4, 6, 8, 12, 30], np.float32)
    stack = jax.tree.map(lambda x: x * scale.reshape((-1,) + (1,) *
                                                     (x.ndim - 1)), stack)
    if codec == "int8":
        return jq.quantize_stack(stack), tq.quantize_stack(
            params_from_jax(stack, "cpu"))
    return stack, params_from_jax(stack, "cpu")


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_row_norms_mask_and_scale_rows_match_jax(codec):
    jstack, tstack = _bank_stack(0, codec)
    np.testing.assert_allclose(tserver.bank_row_norms(tstack),
                               np.asarray(jserver.bank_row_norms(jstack)),
                               rtol=1e-6)
    keep = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    factors = np.linspace(-2, 2, 8).astype(np.float32)
    for jt, tt in ((jserver.mask_rows(jstack, keep),
                    tserver.mask_rows(tstack, keep)),
                   (jserver.scale_rows(jstack, factors),
                    tserver.scale_rows(tstack, factors))):
        assert type(tt) is (tq.QuantStack if codec == "int8" else dict)
        for a, b in zip(tree_leaves(tt), jax.tree.leaves(jt)):
            assert str(a.dtype) == f"torch.{np.asarray(b).dtype}"
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-6)


class _Bank:
    def __init__(self, stacked):
        self.stacked = stacked
        self.capacity = tree_leaves(stacked)[0].shape[0] \
            if not isinstance(stacked, (tq.QuantStack, jq.QuantStack)) \
            else tree_leaves(stacked.q)[0].shape[0]


@pytest.mark.parametrize("method", ["clip", "trim"])
@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_robust_flush_weights_match_jax(method, codec):
    jgroups, tgroups = {}, {}
    for key, seed, rows in (("a", 0, [(0, 0), (2, 1), (3, 0), (7, 0)]),
                            ("b", 1, [(1, 2), (4, 0), (6, 1)])):
        jstack, tstack = _bank_stack(seed, codec)
        jgroups[key] = (_Bank(jstack), rows)
        tgroups[key] = (_Bank(tstack), rows)
    kw = dict(beta=0.8, count=7, damping=0.5, tau_max=1, method=method,
              trim_frac=0.2)
    jout, jinfo = jserver.robust_flush_weights(jgroups, **kw)
    tout, tinfo = tserver.robust_flush_weights(tgroups, **kw)
    assert {k: tinfo[k] for k in ("clipped", "trimmed", "nonfinite")} == \
        {k: jinfo[k] for k in ("clipped", "trimmed", "nonfinite")}
    np.testing.assert_allclose(tinfo["clip_norm"], jinfo["clip_norm"],
                               rtol=1e-6)
    for key in jout:
        np.testing.assert_allclose(tout[key][0], jout[key][0], rtol=1e-5)
        np.testing.assert_array_equal(tout[key][1], jout[key][1])
    norms = np.array([3.0, np.nan, 1.0, 9.0, 2.0, 5.0])
    rows = [(0, 0), (1, 0), (2, 1), (3, 0), (4, 2), (5, 0)]
    kw = dict(beta=1.0, count=6, damping=0.0, tau_max=1, method=method)
    jw, jk, ji = jserver.robust_admission_weights(6, rows, norms, **kw)
    tw, tk, ti = tserver.robust_admission_weights(6, rows, norms, **kw)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tk, jk)
    assert ti == ji
