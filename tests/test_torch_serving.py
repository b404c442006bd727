"""Port of the personalization server (``repro_torch.serving``) against
``repro.serving.PersonalizationServer``: the same submit sequence, from the
same init, into both packages, on the serve bench's linear model (5 users,
4 windows).

Everything integer must be equal: ticket status, τ and window, every integer
``stats`` key, ``ring_bytes_per_user``.  Floats: params after every window
and served heads within 1e-5 for fp32 banking (the stacked applies sum rows
in other orders; each window is a handful of f32 gradient steps).  For int8
banking the same 1e-5 plus one code step, β/M × the largest row scale, for
every code that the two packages' deltas put on opposite sides of a rounding
boundary: the tests count such flips in each window's banks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PersAFLConfig as JConfig
from repro.serving import PersonalizationServer as JServer
from repro_torch.core import PersAFLConfig
from repro_torch.core.subset import merge_subset
from repro_torch.kernels.fused_update import kernel as K
from repro_torch.serving import (MODES, DeltaRing, MicroBatcher,
                                 PersonalizationServer, Ticket,
                                 personalize_strategy)
from repro_torch.tree import tree_leaves

D, CLASSES, USERS, WINDOWS = 32, 10, 5, 4
ATOL = 1e-5
PCFG = dict(option="C", lam=20.0, inner_steps=5, inner_eta=0.05, alpha=0.1,
            beta=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j_loss(p, b):
    logits = b["images"] @ p["w"] + p["b"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.sum(jax.nn.one_hot(b["labels"], CLASSES) * logp, -1))


def t_loss(p, b):
    logits = b["images"] @ p["w"] + p["b"]
    logp = torch.log_softmax(logits, -1)
    # a gather, not one_hot: vmap takes no data-dependent shapes
    return -torch.mean(logp.gather(-1, b["labels"].long()[..., None]))


def _params():
    rng = np.random.RandomState(0)
    return {"w": (0.1 * rng.randn(D, CLASSES)).astype(np.float32),
            "b": np.zeros(CLASSES, np.float32)}


def _batch(seed, n=8):
    rng = np.random.RandomState(seed)
    return {"images": rng.randn(n, D).astype(np.float32),
            "labels": rng.randint(0, CLASSES, n).astype(np.int32)}


def _servers(**kw):
    params = _params()
    js = JServer({k: jnp.asarray(v) for k, v in params.items()}, j_loss,
                 JConfig(**PCFG), **kw)
    ts = PersonalizationServer(params, t_loss, PersAFLConfig(**PCFG),
                               device="cpu", **kw)
    return js, ts


def _int_stats(stats):
    return {k: v for k, v in stats.items()
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool)}


def _max_scale(srv):
    """The largest row scale of the int8 banks the ring holds."""
    return max((float(np.max(np.asarray(x if not isinstance(x, torch.Tensor)
                                        else x.numpy())))
                for bs in srv.ring._banks.values() for b in bs
                if hasattr(b.stacked, "scales")
                for x in (jax.tree.leaves(b.stacked.scales)
                          if not isinstance(srv, PersonalizationServer)
                          else tree_leaves(b.stacked.scales))),
               default=0.0)


def _code_flips(js, ts):
    """Codes that differ between the two packages' banks of the current
    window."""
    pairs = zip(js.ring._banks[js.ring.current],
                ts.ring._banks[ts.ring.current])
    return sum(int((np.asarray(a) != b.numpy()).sum()) for jb, tb in pairs
               for a, b in zip(jax.tree.leaves(jb.stacked.q),
                               tree_leaves(tb.stacked.q)))


def _assert_tree_close(got, want, atol):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   atol=atol, rtol=0)


def _drive(js, ts, mode="C", user_cap=None):
    """Both servers through the same sequence: every user each window, a
    second request from u0 (over the cap when ``user_cap`` is 1), and at
    window 1 two requests queued across the boundary, so window 2 admits
    them as stragglers with τ = 1.  Checks after every window."""
    codec = ts.delta_dtype
    tol = ATOL
    for w in range(WINDOWS):
        tickets = []
        for u in range(USERS):
            b = _batch(100 * w + u)
            tickets.append((js.submit(f"u{u}", b, mode=mode),
                            ts.submit(f"u{u}", b, mode=mode)))
        b = _batch(100 * w + 77)
        tickets.append((js.submit("u0", b, mode=mode),
                        ts.submit("u0", b, mode=mode)))
        assert js.flush() == ts.flush()
        if codec == "int8":
            # one code step per flipped code, see the module docstring
            tol += _code_flips(js, ts) * PCFG["beta"] / USERS * max(
                _max_scale(js), _max_scale(ts))
        for jt, tt in tickets:
            assert (tt.status, tt.tau, tt.window, tt.stamp) == \
                (jt.status, jt.tau, jt.window, jt.stamp)
            if tt.status == "done":
                _assert_tree_close(ts.poll(tt), js.poll(jt), tol)
            else:
                assert tt.status == "capped" and user_cap == 1
                with pytest.raises(RuntimeError, match="fairness cap"):
                    ts.poll(tt)
        users = [f"u{u}" for u in range(USERS)]
        _assert_tree_close(ts.stacked_heads(users), js.stacked_heads(users),
                           tol)
        if w == 1:
            for u in (1, 3):
                b = _batch(100 * w + 50 + u)
                js.submit(f"u{u}", b, mode=mode)
                ts.submit(f"u{u}", b, mode=mode)
            js.advance_window(flush=False)
            ts.advance_window(flush=False)
        else:
            js.advance_window()
            ts.advance_window()
        assert ts.window == js.window == w + 1
        _assert_tree_close(ts.params, js.params, tol)
        assert _int_stats(ts.stats) == _int_stats(js.stats)
        assert ts.stats["delta_codec"] == js.stats["delta_codec"]
        assert (int(ts.state.t), int(ts.state.staleness_max)) == \
            (int(js.state.t), int(js.state.staleness_max))
    assert ts.stats["ring_stragglers"] == 2
    assert ts.stats["host_materializations"] == 0
    return tol


@pytest.mark.parametrize("codec,subset,mode,impl", [
    ("fp32", None, "C", "auto"),
    ("int8", None, "C", "auto"),
    ("fp32", "w", "C", "auto"),
    ("int8", "w", "C", "vmap"),
    ("fp32", None, "B", "vmap"),
    ("int8", None, "B", "auto"),
])
def test_server_matches_reference(codec, subset, mode, impl):
    js, ts = _servers(delta_dtype=codec, personal_subset=subset,
                      modes=(mode,))
    if impl == "vmap":
        for eng in ts.engines.values():
            eng.cohort_impl = "vmap"
    _drive(js, ts, mode=mode)
    assert K.LAUNCHES["apply_rows_q"] == 0     # CPU tensors: plain version
    if subset is not None:
        # the backbone never moves
        np.testing.assert_array_equal(ts.params["b"].numpy(),
                                      _params()["b"])
        assert set(ts.head("u0")) == {"w"}


def test_server_user_cap_matches_reference():
    js, ts = _servers(user_cap=1, modes=("C",))
    _drive(js, ts, user_cap=1)
    # u0's second request in every window, and the window-1 stragglers of
    # users who already have a row in window 2
    assert ts.stats["batcher_fairness_capped"] == WINDOWS + 2


@pytest.mark.parametrize("robust", ["clip", "trim"])
def test_server_robust_matches_reference(robust):
    # u4's requests have 20x the features: its delta norm sits far from
    # the others', away from the median and the clip bound
    js, ts = _servers(robust=robust, modes=("C",), trim_frac=0.2)
    for w in range(3):
        for u in range(USERS):
            b = _batch(100 * w + u)
            if u == 4:
                b = dict(b, images=20 * b["images"])
            js.submit(f"u{u}", b)
            ts.submit(f"u{u}", b)
        js.advance_window()
        ts.advance_window()
        _assert_tree_close(ts.params, js.params, ATOL)
        assert _int_stats(ts.stats) == _int_stats(js.stats)
    key = "ring_robust_clipped" if robust == "clip" \
        else "ring_robust_trimmed"
    assert ts.stats[key] > 0


def test_server_refuses_multi_device_and_transport():
    # the sharded server needs a process group (tests/test_torch_mesh_
    # parity.py starts one per spawned rank)
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        PersonalizationServer(_params(), t_loss, PersAFLConfig(**PCFG),
                              device="cpu", cohort_impl="shard_map")
    # a mesh without a "cohort" axis (the production ("data", "model")
    # layout) cannot carry the cohort
    production = type("Mesh", (), {"mesh_dim_names": ("data", "model")})()
    with pytest.raises(ValueError, match="'cohort' axis"):
        PersonalizationServer(_params(), t_loss, PersAFLConfig(**PCFG),
                              device="cpu", cohort_impl="shard_map",
                              mesh=production)
    # the transport is ported: its names are the transport module's
    import repro_torch.serving as serving
    from repro_torch.serving import transport
    for name in ("AsyncTransportClient", "TransportBusy", "TransportClient",
                 "TransportError", "TransportServer"):
        assert getattr(serving, name) is getattr(transport, name)
    with pytest.raises(AttributeError):
        serving.bogus  # noqa: B018


def test_removed_personalize_delta_fn_names_its_replacement():
    import repro_torch.serving as serving
    from repro_torch.serving import batcher
    for mod in (serving, batcher):
        with pytest.raises(ImportError,
                           match=r"strategy\('personalize', mode=\.\.\.\) "
                                 r"/ personalize_strategy"):
            mod.personalize_delta_fn  # noqa: B018
    with pytest.raises(AttributeError):
        batcher.bogus  # noqa: B018


def test_server_raises_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PersonalizationServer(_params(), t_loss, PersAFLConfig(**PCFG))
    srv = PersonalizationServer(_params(), t_loss, PersAFLConfig(**PCFG),
                                device="cpu")
    assert tree_leaves(srv.params)[0].device.type == "cpu"


def test_batcher_ring_and_strategy_surface():
    assert MODES == ("B", "C")
    strat = personalize_strategy(PersAFLConfig(**PCFG), t_loss, "C",
                                 personal_subset="w")
    delta, cstate, metrics = strat.local_update(
        {k: torch.from_numpy(v) for k, v in _params().items()},
        {k: torch.from_numpy(v) for k, v in _batch(0).items()}, None)
    assert set(delta) == {"w"} and cstate is None and metrics == {}
    with pytest.raises(ValueError, match="mode"):
        personalize_strategy(PersAFLConfig(), t_loss, "A")
    batcher = MicroBatcher({})
    with pytest.raises(ValueError, match="not enabled"):
        batcher.submit(Ticket(user="u", mode="C", stamp=0), {})
    ring = DeltaRing({"w": torch.zeros(3)}, windows=2)
    with pytest.warns(UserWarning, match="clamped"):
        deep = DeltaRing({"w": torch.zeros(3)}, windows=2, tau_max=5)
    assert (ring.tau_max, deep.tau_max, deep.tau_max_requested) == (1, 1, 5)
    with pytest.raises(ValueError):
        DeltaRing({"w": torch.zeros(3)}, delta_dtype="int4")
    # a served head-only tree merges over the backbone
    full = {"w": torch.zeros(2), "b": torch.ones(1)}
    merged = merge_subset(full, {"w": torch.full((2,), 3.0)})
    assert merged["b"] is full["b"] and float(merged["w"][0]) == 3.0
