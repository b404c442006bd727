"""The mesh is a layout, never a semantics (``tests/test_mesh_parity.py``'s
two contracts, on the port): an ``FLRun`` and a ``PersonalizationServer``
driven on the 1-D ``("cohort",)`` mesh, the 2-D ``(8, 1)`` mesh and the 2-D
``(2, 4)`` mesh (model-sharded storage) give bit-equal params, histories
and served heads.

One spawn of 8 ``gloo`` ranks (``tests/torch_ranks.py``, body ``parity``)
drives every layout and also checks the mesh cache, its validation and the
``use_mesh`` context; no process group is started in the pytest process.
The port's ``FLRun`` is also held against the JAX package's ``FLRun`` (one
device) on the same clients: params within ``PARAM_ATOL`` = 1e-6
(``tests/test_torch_flrun.py``'s), timelines equal.  On the 2x4 mesh each
rank's peak delta/head/snapshot/params residency is at most 0.6 of the 1-D
mesh's (the reference measured ~0.39).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import PersAFLConfig as JConfig
from repro.data.federated import ClientData as JClientData
from repro.fl import DelayModel as JDelayModel
from repro.fl import FLRun as JFLRun
from repro.fl import buffered as jbuffered
from torch_rank_bodies import SERVE_USERS, flrun_clients
from torch_ranks import spawn

WORLD = 8
PARAM_ATOL = 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("parity", WORLD, tmp_path_factory.mktemp("parity_ranks"),
                 timeout_s=150)


@pytest.fixture(scope="module")
def r0(ranks):
    return ranks[0]


def test_cohort_mesh_is_memoized(r0):
    assert r0["memo_same"] and r0["memo_spellings"]
    assert r0["cache_len"] == 1


def test_reset_mesh_cache_invalidates(r0):
    assert r0["cache_len_reset"] == 0 and r0["cache_len_rebuilt"] == 1


def test_engines_share_one_mesh_object(r0):
    assert r0["engines_share_mesh"]


@pytest.mark.parametrize("bad", [WORLD + 1, 0, 3])
def test_cohort_model_mesh_validates_divisibility(r0, bad):
    assert r0[f"validate_{bad}"] == (f"model_axis={bad} must divide the "
                                     f"device count ({WORLD})")


def test_cohort_model_mesh_degenerate_axis(r0):
    names, shape, cohort, memo, distinct = r0["m81"]
    assert names == ("cohort", "model") and shape == (WORLD, 1)
    assert cohort == WORLD and memo and distinct
    assert r0["m24_cohort"] == 2


def test_use_mesh_context_installs_and_restores(r0):
    assert r0["active_before"] and r0["active_after"]
    assert r0["use_mesh"] == (True, True, 2)


@pytest.mark.parametrize("layout", ["81", "24"])
def test_flrun_bit_parity_across_mesh_layouts(r0, layout):
    one, other = r0["flrun"]["1d"], r0["flrun"][layout]
    np.testing.assert_array_equal(other["w"], one["w"])
    for key in ("staleness", "times", "rounds", "active_times",
                "active_ratio", "end_time", "t"):
        assert other[key] == one[key], key
    assert other["hm"] == 0


def test_flrun_2d_params_stay_model_sharded(ranks):
    for r in ranks:
        assert r["flrun"]["24"]["placements"] == \
            "(Replicate(), Shard(dim=1))"
        np.testing.assert_array_equal(r["flrun"]["24"]["w"],
                                      ranks[0]["flrun"]["1d"]["w"])


def test_flrun_matches_the_jax_flrun(r0):
    """The reference's FLRun on one device, the same six clients and
    seeds: the numpy timeline is equal, the params within 1e-6."""
    clients = [JClientData(train_x=x, train_y=y, test_x=x[:8], test_y=y[:8],
                           classes=(0, 1, 2, 3)) for x, y in flrun_clients()]

    def loss(p, b):
        logp = jax.nn.log_softmax(b["images"] @ p["w"])
        return -jnp.mean(jnp.sum(jax.nn.one_hot(b["labels"], 4) * logp, -1))

    run = JFLRun(clients=clients, loss_fn=loss,
                 init_params={"w": jnp.zeros((8, 4))},
                 pcfg=JConfig(option="A", q_local=2, eta=0.05),
                 delays=JDelayModel(6, seed=1), strategy="persafl",
                 schedule=jbuffered(2), batch_size=8, seed=0)
    hist = run.run(max_rounds=4)
    got = r0["flrun"]["24"]
    want = np.asarray(run.state.params["w"])
    np.testing.assert_allclose(got["w"], want, atol=PARAM_ATOL, rtol=0)
    assert not np.allclose(np.zeros_like(want), want, atol=PARAM_ATOL)
    assert got["staleness"] == list(hist.staleness)
    assert got["active_times"] == list(hist.active_times)
    assert got["active_ratio"] == list(hist.active_ratio)
    assert got["end_time"] == hist.end_time
    assert got["t"] == int(run.state.t)


def test_serving_heads_and_params_bit_equal_across_layouts(r0):
    one, two = r0["serve"]["1d"], r0["serve"]["24"]
    for u in SERVE_USERS:
        for k in ("w", "b"):
            np.testing.assert_array_equal(two["heads"][u][k],
                                          one["heads"][u][k])
    for k in ("w", "b"):
        np.testing.assert_array_equal(two["params"][k], one["params"][k])
    # the users sit on distinct cohort slices: the 1-D keying pads each of
    # 8 slices to one slot per window (4 users, 4 padding rows)
    assert one["shard_padding"] == 4 * 4 and two["shard_padding"] == 0


@pytest.mark.parametrize("variant", ["serve_int8", "serve_clip"])
def test_int8_and_robust_serving_bit_equal_across_layouts(ranks, variant):
    """int8 banking (each rank quantizes its own rows at full width, the
    codes placed as the rows) and the robust clip window give the same
    heads and params on the 1-D and 2x4 meshes, with no host copy."""
    one, two = ranks[0][variant]["1d"], ranks[0][variant]["24"]
    for u in SERVE_USERS:
        for k in ("w", "b"):
            np.testing.assert_array_equal(two["heads"][u][k],
                                          one["heads"][u][k])
    for k in ("w", "b"):
        np.testing.assert_array_equal(two["params"][k], one["params"][k])
    for r in ranks:
        assert r[variant]["1d"]["hm"] == 0 and r[variant]["24"]["hm"] == 0
    if variant == "serve_clip":
        assert one["clipped"] == two["clipped"] > 0


def test_serving_never_materializes_and_stays_model_sharded(ranks):
    for r in ranks:
        assert r["serve"]["1d"]["hm"] == 0 and r["serve"]["24"]["hm"] == 0
        assert r["serve"]["24"]["placements"] == \
            "(Replicate(), Shard(dim=1))"


def test_serving_2x4_residency_at_most_0_6_of_1d(ranks):
    peak1 = max(r["serve"]["1d"]["bytes"] for r in ranks)
    peak2 = max(r["serve"]["24"]["bytes"] for r in ranks)
    assert peak2 / peak1 <= 0.6, (peak1, peak2)
