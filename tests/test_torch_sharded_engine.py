"""The port's ``cohort_impl="shard_map"`` engine on 8 spawned ``gloo``
ranks, against its one-device ``"map"`` engine, as
``tests/test_sharded_engine.py`` holds the reference's against ``vmap``.

One spawn (``tests/torch_ranks.py``, body ``engine``) runs every check on
a 1-D ``("cohort",)`` mesh of 8 ranks (and the 2x4 ``("cohort", "model")``
mesh for the model-split rows); the tests read its results.  No process
group is started in the pytest process.  Tolerances are the reference
test's: rows rtol 1e-5 / atol 1e-5, the masked mean rtol 1e-5 / atol 1e-6.
The sequential applies (``apply_rows_seq_ref``, ``apply_rows_q_seq_ref``)
are held against the JAX package's on a permuted order in f32 (1e-6), bf16
(one ulp: rtol 2^-7, atol 1e-5, the fused-update port's bf16 bound) and
int8 codes (1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_update import ref as jref
from repro_torch.fl import CohortEngine, strategy
from repro_torch.kernels.fused_update import ops
from repro_torch.kernels.fused_update import ref as tref
from torch_rank_bodies import client_batches, quad_loss, quad_params, quad_pcfg
from torch_ranks import spawn

WORLD = 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("engine", WORLD, tmp_path_factory.mktemp("engine_ranks"),
                 timeout_s=150)


@pytest.fixture(scope="module")
def r0(ranks):
    return ranks[0]


def _map_rows(option, k=32):
    eng = CohortEngine(quad_pcfg(option), quad_loss, cohort_impl="map",
                       device="cpu")
    bank = eng.update_cohort(quad_params(),
                             [client_batches(s) for s in range(k)])
    return bank.stacked["w"][:k].numpy(), eng


@pytest.mark.parametrize("option", ["A", "B", "C"])
def test_shard_map_cohort_matches_map(r0, option):
    want, _ = _map_rows(option)
    np.testing.assert_allclose(r0[f"rows_{option}"][:32], want, rtol=1e-5,
                               atol=1e-5)
    # each rank computed its own block of 32 / 8 rows
    assert r0[f"local_rows_{option}"] == (4, 5)


def test_every_rank_holds_the_same_bank(ranks):
    for r in ranks[1:]:
        for key in ("rows_A", "rows_B", "rows_C", "mean13", "flush"):
            np.testing.assert_array_equal(r[key], ranks[0][key])


def test_shard_map_mean_single_all_reduce_matches_map(r0):
    """The masked mean (each rank's rows, one all_reduce per leaf over
    "cohort") at a cohort of 13 on 8 slices (bucket 16, 3 padding rows)."""
    eng = CohortEngine(quad_pcfg("A"), quad_loss, cohort_impl="map",
                       device="cpu")
    want = eng.update_cohort_mean(quad_params(),
                                  [client_batches(s) for s in range(13)])
    np.testing.assert_allclose(r0["mean13"], want["w"].numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("k", [5, 13, 17])
def test_padding_waste_matches_map_at_non_pow2_cohorts(r0, k):
    """The sharded bucket (a cohort-axis multiple) is the pow2 bucket when
    pow2(k) ≥ 8, else the cohort-axis size."""
    _, eng = _map_rows("A", k)
    pow2 = 1 << (k - 1).bit_length()
    assert eng.stats["padding_waste"] == pow2 - k
    assert r0["ndev"] == WORLD
    if pow2 >= WORLD:
        assert r0[f"waste_{k}"] == eng.stats["padding_waste"]
    else:
        assert r0[f"waste_{k}"] == WORLD - k
    assert r0[f"cap_{k}"] % WORLD == 0


def test_shard_map_stateful_strategy_matches_map(r0):
    """SCAFFOLD's state stack stays split over "cohort"; deltas and every
    client's updated state agree with the map engine."""
    params = quad_params()
    strat = strategy("scaffold").bind(quad_pcfg("A"), quad_loss)
    eng = CohortEngine(quad_pcfg("A"), quad_loss, cohort_impl="map",
                       strategy=strat, device="cpu")
    cstates = [strat.dispatch_state(strat.init_client_state(params))
               for _ in range(8)]
    bank = eng.update_cohort(params, [client_batches(s) for s in range(8)],
                             cstate_list=cstates)
    assert r0["scaffold_sharded"]
    for i in range(8):
        np.testing.assert_allclose(r0["scaffold_states"][i]["w"],
                                   bank.client_state(i)["w"].numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r0["scaffold_rows"], bank.stacked["w"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_sharded_flush_is_the_sequential_apply_on_device(r0):
    """A buffered flush from a sharded bank takes the sequential apply in
    the given order (no kernel on the CPU, no host copy); a row asked for
    afterwards counts one host materialization."""
    np.testing.assert_array_equal(r0["flush"], r0["flush_seq_ref"])
    assert r0["flush_launches"] == 0
    assert r0["hm_before_row"] == 0 and r0["hm_after_row"] == 1
    assert r0["restacked_equal"] and r0["restacked_sharded"]
    want, _ = _map_rows("A", 6)
    np.testing.assert_allclose(r0["row0"], want[0], rtol=1e-5, atol=1e-5)


def test_2x4_rows_are_the_1d_bits_split_on_both_axes(ranks):
    """On the 2x4 mesh with w's 5 entries split over "model" (2, 2, 1, 0),
    each rank stores its piece of 8 of 16 rows and the gathered bank is the
    1-D mesh's rows, bit for bit."""
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["rows_A_24"],
                                      ranks[0]["rows_A"][:16])
        assert r["local_rows_A_24"] == (8, (2, 2, 1, 0)[rank % 4])
        assert r["placements_24"] == "(Shard(dim=0), Shard(dim=1))"


def test_2x4_mean_reduces_over_cohort_only(r0):
    """The masked mean on the 2x4 mesh equals the 1-D mesh's and the map
    engine's: the all_reduce does not cross "model"."""
    np.testing.assert_allclose(r0["mean13_24"], r0["mean13"], rtol=1e-6,
                               atol=1e-7)


def _seq_case(dtype, seed=0, M=12, shape=(33, 7)):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    d = rng.randn(M, *shape).astype(np.float32)
    s = (rng.rand(M) * 0.3).astype(np.float32)
    s[-3:] = 0.0                                   # padding rows
    order = rng.permutation(M).astype(np.int32)
    return w, d, s, order


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rows_seq_ref_matches_reference(dtype):
    w, d, s, order = _seq_case(dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = np.asarray(jref.apply_rows_seq_ref(
        jnp.asarray(w, jdt), jnp.asarray(d), jnp.asarray(s),
        jnp.asarray(order)).astype(jnp.float32))
    got = tref.apply_rows_seq_ref(torch.from_numpy(w).to(tdt),
                                  torch.from_numpy(d), torch.from_numpy(s),
                                  order)
    assert got.dtype == tdt
    tol = dict(rtol=2 ** -7, atol=1e-5) if dtype == "bf16" \
        else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    change = w - want
    assert not np.allclose(w, want, **tol)           # a no-op fails
    assert not np.allclose(w + change, want, **tol)  # a sign flip fails
    # the tree front's "seq" mode is the ref in that order
    out = ops.apply_rows_tree({"a": torch.from_numpy(w).to(tdt)},
                              {"a": torch.from_numpy(d)},
                              torch.from_numpy(s), mode="seq", order=order)
    np.testing.assert_array_equal(out["a"].float().numpy(),
                                  got.float().numpy())


def test_apply_rows_q_seq_ref_matches_reference():
    rng = np.random.RandomState(1)
    M, shape = 10, (17, 9)
    w = rng.randn(*shape).astype(np.float32)
    q = rng.randint(-127, 128, (M,) + shape).astype(np.int8)
    sc = (rng.rand(M) * 0.02).astype(np.float32)
    s = (rng.rand(M) * 0.5).astype(np.float32)
    order = rng.permutation(M).astype(np.int32)
    want = np.asarray(jref.apply_rows_q_seq_ref(
        jnp.asarray(w), jnp.asarray(q), jnp.asarray(sc), jnp.asarray(s),
        jnp.asarray(order)))
    got = tref.apply_rows_q_seq_ref(torch.from_numpy(w), torch.from_numpy(q),
                                    torch.from_numpy(sc), torch.from_numpy(s),
                                    order)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(w, want, rtol=1e-6, atol=1e-6)
    out = ops.apply_rows_q_tree({"a": torch.from_numpy(w)},
                                {"a": torch.from_numpy(q)},
                                {"a": torch.from_numpy(sc)},
                                torch.from_numpy(s), mode="seq", order=order)
    np.testing.assert_array_equal(out["a"].numpy(), got.numpy())
