"""Port of the npz checkpoint store (``repro_torch.checkpoint.store``) and of
``PersonalizationServer.save`` / ``.restore``: a file written by either
package loads in the other.

Trees must come back with their structure (pruned lists keep their gaps),
dtypes (bf16 by its bits) and values bit for bit.  A server saved by one
package and restored by the other must carry the same params, window, server
counters and cumulative ring stats, serve the same heads and, after one more
window in both, agree within the serving tests' 1e-5.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core import PersAFLConfig as JConfig
from repro.serving import PersonalizationServer as JServer
from repro_torch.checkpoint import store as tstore
from repro_torch.core import PersAFLConfig
from repro_torch.core.types import ServerState
from repro_torch.serving import PersonalizationServer
from repro_torch.tree import tree_leaves

D, CLASSES, USERS = 16, 6, 4
ATOL = 1e-5
PCFG = dict(option="C", lam=20.0, inner_steps=3, inner_eta=0.05, alpha=0.1,
            beta=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j_loss(p, b):
    logp = jax.nn.log_softmax(b["images"] @ p["w"] + p["b"])
    return -jnp.mean(jnp.sum(jax.nn.one_hot(b["labels"], CLASSES) * logp, -1))


def t_loss(p, b):
    logp = torch.log_softmax(b["images"] @ p["w"] + p["b"], -1)
    return -torch.mean(logp.gather(-1, b["labels"].long()[..., None]))


def _params():
    rng = np.random.RandomState(0)
    return {"w": (0.1 * rng.randn(D, CLASSES)).astype(np.float32),
            "b": np.zeros(CLASSES, np.float32)}


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"images": rng.randn(8, D).astype(np.float32),
            "labels": rng.randint(0, CLASSES, 8).astype(np.int32)}


def _tree():
    rng = np.random.RandomState(1)
    return {"a": rng.randn(3, 2).astype(np.float32),
            "gap": [None, {"q": rng.randint(-127, 128, 5).astype(np.int8)},
                    None, rng.randn(2).astype(ml_dtypes.bfloat16)],
            "n": np.int32(7)}


def _same(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) \
        and a.dtype == torch.bfloat16 else np.asarray(a)
    b = np.asarray(b)
    if b.dtype == ml_dtypes.bfloat16:
        b = b.astype(np.float32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pytree_round_trips_across_packages(tmp_path, writer):
    tree = _tree()
    path = str(tmp_path / "tree")
    if writer == "jax":
        jstore.save_pytree(path, tree, meta={"k": 1})
    else:
        port = {"a": torch.from_numpy(tree["a"]),
                "gap": [None, {"q": torch.from_numpy(tree["gap"][1]["q"])},
                        None, torch.tensor(tree["gap"][3].astype(np.float32),
                                           dtype=torch.bfloat16)],
                "n": np.int32(7)}
        tstore.save_pytree(path, port, meta={"k": 1})
    for load in (jstore.load_pytree, tstore.load_pytree):
        back = load(path)
        assert back["gap"][0] is None and back["gap"][2] is None
        assert back["gap"][1]["q"].dtype == np.int8
        _same(back["gap"][1]["q"], tree["gap"][1]["q"])
        _same(back["a"], tree["a"])
        _same(back["gap"][3], tree["gap"][3])
        assert int(back["n"]) == 7
    bf = tstore.load_pytree(path)["gap"][3]
    assert isinstance(bf, torch.Tensor) and bf.dtype == torch.bfloat16
    assert str(jstore.load_pytree(path)["gap"][3].dtype) == "bfloat16"
    assert tstore.load_meta(path) == jstore.load_meta(path) == {"k": 1}


def test_server_state_round_trips(tmp_path):
    path = str(tmp_path / "state")
    st = ServerState(params={"w": torch.ones(2)}, t=np.int32(5),
                     staleness_sum=np.float32(2.5), staleness_max=np.int32(3))
    tstore.save_server_state(path, st)
    back = tstore.load_server_state(path)
    assert isinstance(back, ServerState)
    assert (back.t, back.staleness_sum, back.staleness_max) == (5, 2.5, 3)
    assert back.t.dtype == np.int32
    jback = jstore.load_server_state(path)
    assert int(jback.t) == 5
    np.testing.assert_array_equal(np.asarray(jback.params["w"]), [1.0, 1.0])


def _drive(srv, windows, start=0):
    for w in range(start, start + windows):
        for u in range(USERS):
            srv.submit(f"u{u}", _batch(100 * w + u))
        srv.flush()
        if w == start:
            srv.submit("u1", _batch(100 * w + 50))
            srv.advance_window(flush=False)
        else:
            srv.advance_window()


def _close(got, want, atol=ATOL):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("codec,subset", [("fp32", None), ("int8", None),
                                          ("int8", "w")])
def test_server_checkpoint_restores_across_packages(tmp_path, direction,
                                                    codec, subset):
    params = _params()
    kw = dict(delta_dtype=codec, personal_subset=subset, modes=("C",))
    js = JServer({k: jnp.asarray(v) for k, v in params.items()}, j_loss,
                 JConfig(**PCFG), **kw)
    ts = PersonalizationServer(params, t_loss, PersAFLConfig(**PCFG),
                               device="cpu", **kw)
    _drive(js, 3)
    _drive(ts, 3)
    path = str(tmp_path / "srv")
    if direction == "jax_to_port":
        js.save(path)
        ts2 = PersonalizationServer.restore(path, t_loss,
                                            PersAFLConfig(**PCFG),
                                            device="cpu", modes=("C",))
        js2 = js
    else:
        ts.save(path)
        js2 = JServer.restore(path, j_loss, JConfig(**PCFG), modes=("C",))
        ts2 = ts
    users = [f"u{u}" for u in range(USERS)]
    assert ts2.window == js2.window == 3
    assert (int(ts2.state.t), float(ts2.state.staleness_sum),
            int(ts2.state.staleness_max)) == (
        int(js2.state.t), float(js2.state.staleness_sum),
        int(js2.state.staleness_max))
    assert ts2.ring.stats == {k: int(v) for k, v in js2.ring.stats.items()}
    assert ts2.delta_dtype == js2.delta_dtype == codec
    assert sorted(ts2.ring._snapshots) == sorted(js2.ring._snapshots)
    _close(ts2.params, js2.params)
    _close(ts2.stacked_heads(users), js2.stacked_heads(users))
    assert list(ts2._residuals) == list(js2._residuals)
    # the restored server carries on: one more window in both
    _drive(js2, 1, start=3)
    _drive(ts2, 1, start=3)
    _close(ts2.params, js2.params)
