"""Port of the socket transport (``repro_torch.serving.transport``) against
``repro.serving.transport``: wire protocol v1 byte for byte, the port's
``TransportServer`` through the reference's own transport cases, clean
shutdown with a connection open, clients of one package against servers
of the other, a client in a second OS process, and ``launch/serve.py
--listen`` in a child process.

Nothing here waits without a limit: every async case runs under
``asyncio.wait_for(..., 30)``, blocking clients carry a socket timeout and
child processes a 60 s timeout.  Heads from the other package's in-process
server agree within ATOL = 1e-5 (``tests/test_torch_serving.py``); heads
from the port's own in-process server agree bit for bit.
"""
import asyncio
import io
import os
import re
import struct
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import PersAFLConfig as JConfig
from repro.serving import PersonalizationServer as JServer
from repro.serving import transport as JT
from repro_torch.core import PersAFLConfig
from repro_torch.serving import PersonalizationServer
from repro_torch.serving import transport as T
from repro_torch.serving.transport import (AsyncTransportClient,
                                           TransportBusy, TransportError,
                                           TransportServer)
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
D, CLASSES = 5, 4
PCFG = dict(option="C", lam=20.0, inner_steps=5, inner_eta=0.05, alpha=0.1,
            beta=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(go, limit=30.0):
    return asyncio.run(asyncio.wait_for(go(), limit))


def j_loss(p, b):
    logp = jax.nn.log_softmax(b["x"] @ p["w"] + p["b"])
    return -jnp.mean(jnp.sum(jax.nn.one_hot(b["y"], CLASSES) * logp, -1))


def t_loss(p, b):
    logp = torch.log_softmax(b["x"] @ p["w"] + p["b"], -1)
    return -torch.mean(logp.gather(-1, b["y"].long()[..., None]))


def user_batch(seed, n=8, d=D):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, d).astype(np.float32),
            "y": rng.randint(0, CLASSES, n).astype(np.int32)}


def _params(d=D):
    rng = np.random.RandomState(0)
    return {"w": (0.1 * rng.randn(d, CLASSES)).astype(np.float32),
            "b": np.zeros((CLASSES,), np.float32)}


def _server(**kw):
    kw.setdefault("max_pending", 64)
    return PersonalizationServer(_params(), t_loss, PersAFLConfig(**PCFG),
                                 device="cpu", **kw)


def _jserver(**kw):
    kw.setdefault("max_pending", 64)
    return JServer({k: jnp.asarray(v) for k, v in _params().items()}, j_loss,
                   JConfig(**PCFG), **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bitwise_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


def _close(got, want, atol=ATOL):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=atol, rtol=0)


# -- (f) launch/serve.py --listen in a child process ------------------------
# The child serves SERVE_S seconds from its "serving ..." line.  The first
# test drives it and leaves its connection open; the file's last test
# checks that the child still stops in time.  The other tests run in
# between, so the file does not wait the serving time out.

SERVE_S = 8.0


@pytest.fixture(scope="module")
def listen_child():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-130m", "--smoke", "--device", "cpu", "--listen", "0",
         "--personal-subset", "embed/unembed", "--delta-dtype", "int8",
         "--serve-seconds", str(SERVE_S)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    child = {"proc": proc, "line": proc.stdout.readline(),
             "t_line": time.perf_counter(), "client": None}
    yield child
    if child["client"] is not None:
        child["client"].close()
    if proc.poll() is None:
        proc.kill()
        proc.communicate(timeout=60)


def test_serve_listen_in_a_child_process(listen_child):
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.serve import _personalize_len, _user_batch
    cfg = reduce_for_smoke(get_config("mamba2-130m"))
    m = re.match(r"serving personalization on 127\.0\.0\.1:(\d+) "
                 r"\(wire protocol v1, mode C", listen_child["line"])
    assert m, listen_child["line"]
    c = listen_child["client"] = T.TransportClient(
        "127.0.0.1", int(m.group(1)), timeout=30.0, codec="int8")
    head = c.poll(c.submit("user0", _user_batch(cfg, 0, _personalize_len(
        cfg, 8))), wait_ms=20_000)
    assert c.last_codec == "int8" and c.last_subset == ["embed/unembed"]
    assert list(head) == ["embed"] and list(head["embed"]) == ["unembed"]
    assert head["embed"]["unembed"].shape == (cfg.d_model, cfg.vocab)
    assert np.isfinite(head["embed"]["unembed"]).all()
    assert c.advance() == 1
    stats = c.stats()
    assert stats["host_materializations"] == 0
    assert stats["cohort_calls"] == 1 and stats["wire_codec"] == "int8"
    # the connection stays open; the file's last test sees the child stop


# -- (a) the codec across the packages ---------------------------------------

def _trees():
    """The same values as the reference's leaves (bf16 as ml_dtypes) and as
    the port's (bf16 as a torch tensor; an f32 leaf as a tensor too)."""
    rng = np.random.RandomState(3)
    f32 = rng.randn(3, 4).astype(np.float32)
    f64 = rng.randn(5).astype(np.float64)
    i32 = rng.randint(-9, 9, (2, 2)).astype(np.int32)
    b16 = rng.randn(2, 3).astype(np.float32)
    ref = {"a": f32, "nested": [{"d": f64, "i": i32},
                                b16.astype(ml_dtypes.bfloat16)]}
    port = {"a": torch.from_numpy(f32.copy()),
            "nested": [{"d": f64, "i": torch.from_numpy(i32.copy())},
                       torch.from_numpy(b16).to(torch.bfloat16)]}
    return ref, port


def _bits(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    a = _np(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_encode_gives_the_reference_bytes(codec):
    ref, port = _trees()
    want = JT.encode_pytree(ref, codec=codec)
    assert T.encode_pytree(port, codec=codec) == want
    assert T.encode_pytree(ref, codec=codec) == want
    # each package decodes the other's bytes to equal leaves
    mine, theirs = T.decode_pytree(want), JT.decode_pytree(want)
    lm, lt = tree_leaves(mine), jax.tree.leaves(theirs)
    assert len(lm) == len(lt) == 4
    for a, b in zip(lm, lt):
        assert np.array_equal(_bits(a), _bits(b))
    assert isinstance(mine["nested"][1], torch.Tensor) \
        and mine["nested"][1].dtype == torch.bfloat16
    if codec == "int8":
        # f32/f64 leaves come back dequantized as f32, within a code step
        for key in ("a",):
            x = _np(port[key])
            step = np.abs(x).max() / 127
            assert np.abs(mine[key] - x).max() <= step / 2 + 1e-7
        assert mine["nested"][0]["d"].dtype == np.float32
    else:
        _bitwise_equal(mine["nested"][0], ref["nested"][0])


def test_frames_match_the_reference_and_refuse_bad_payloads():
    header = {"op": "SUBMIT", "user": "u0", "mode": "C", "codec_ok": True}
    body = b"\x00\x01binary\xff"
    framed = T.pack_frame(header, body)
    assert framed == JT.pack_frame(header, body)
    (n,) = struct.unpack("!I", framed[:4])
    assert n == len(framed) - 4
    assert T.split_frame(framed[4:]) == (header, body)
    for bad, msg in ((b"\x00\x01", "truncated"),
                     (struct.pack("!I", 99) + b"{}", "exceeds"),
                     (struct.pack("!I", 3) + b"{x]", "bad header JSON"),
                     (struct.pack("!I", 2) + b"[]", "JSON object")):
        with pytest.raises(T.ProtocolError, match=msg):
            T.split_frame(bad)
    assert (T.PROTOCOL_VERSION, T.WIRE_CODECS, T.Q8_KEY_PREFIX,
            T.MAX_FRAME_BYTES) == (JT.PROTOCOL_VERSION, JT.WIRE_CODECS,
                                   JT.Q8_KEY_PREFIX, JT.MAX_FRAME_BYTES)
    with pytest.raises(ValueError, match="codec"):
        T.encode_pytree({}, codec="int4")


def test_stats_become_json_numbers():
    got = T._jsonable({"a": torch.tensor(3), "b": torch.tensor(0.5),
                       "c": np.float32(1.5), "d": "int8", "e": np.int64(7),
                       "f": [1], "g": torch.zeros(2)})
    assert got == {"a": 3, "b": 0.5, "c": 1.5, "d": "int8", "e": 7}
    assert type(got["a"]) is int and type(got["b"]) is float


# -- the ring's per-user lookups against the reference -----------------------

def test_ring_lookups_match_reference():
    js, ts = _jserver(windows=2), _server(windows=2)
    users = ["u0", "u1", "u2", "u3"]
    for w in range(3):
        # 3 users a window (one cohort shape); u2 only in window 0
        for i, u in enumerate(users[:3] if w == 0 else ["u0", "u1", "u3"]):
            js.submit(u, user_batch(10 * w + i))
            ts.submit(u, user_batch(10 * w + i))
        js.flush()
        ts.flush()
        for u in users:
            assert ts.ring.admitted_rows(u) == js.ring.admitted_rows(u)
            jl, tl = js.ring.lookup(u), ts.ring.lookup(u)
            assert (tl is None) == (jl is None)
            if tl is not None:
                assert (tl[0], tl[2]) == (jl[0], jl[2])
        js.advance_window()
        ts.advance_window()
        # u2 admitted only in window 0: retired past the 2-window horizon
        for u in users:
            assert (ts.ring.lookup(u) is None) == (js.ring.lookup(u) is None)
            assert ts.ring.admitted_rows(u) == 0
    assert ts.ring.lookup("u2") is None and ts.ring.lookup("u0") is not None
    bank = ts.ring.lookup("u0")[1]
    assert ts.ring.admit("late", bank, 0, 0) is True
    assert ts.ring.admit("stale", bank, 0, 5) is False
    ts.ring.load({ts.window: ts.ring._snapshots[ts.window]}, ts.window)
    assert ts.ring.lookup("u0") is None


# -- (b) the port's server, as the reference's transport tests run theirs ----

def test_round_trip_flush_timer_head_bitwise():
    ref = _server()
    t_ref = ref.submit("u0", user_batch(0))
    ref.flush()
    expected = ref.poll(t_ref)

    async def go():
        srv = _server()
        ts = await TransportServer(srv, flush_ms=150.0).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        tid = await c.submit("u0", user_batch(0))
        assert await c.poll(tid) is None        # below max_pending: queued
        head = await c.poll(tid, wait_ms=10_000)   # the flush timer fires
        assert head is not None
        assert ts.stats["timer_flushes"] == 1
        again = await c.head("u0")
        stats = await c.stats()
        await c.close()
        await ts.stop()
        return head, again, stats

    head, again, stats = run(go)
    _bitwise_equal(head, expected)
    _bitwise_equal(again, expected)
    assert stats["host_materializations"] == 0
    assert stats["cohort_calls"] == 1 and stats["window"] == 0


def test_full_queue_flushes_synchronously_not_by_timer():
    async def go():
        srv = _server(max_pending=3)
        ts = await TransportServer(srv, flush_ms=60_000.0).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        tids = [await c.submit(f"u{i}", user_batch(i)) for i in range(3)]
        heads = [await c.poll(t, wait_ms=1_000) for t in tids]
        assert all(h is not None for h in heads)
        assert ts.stats["timer_flushes"] == 0
        assert srv.stats["cohort_calls"] == 1
        await c.close()
        await ts.stop()

    run(go)


def test_refusals_surface_typed_errors():
    async def go():
        srv = _server(windows=2)                 # tau_max = 1
        ts = await TransportServer(srv, flush_ms=60_000.0).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        tid = await c.submit("slow", user_batch(0))
        await c.advance(flush=False)
        await c.advance(flush=False)             # tau = 2 > tau_max
        await c.flush()
        with pytest.raises(TransportError) as ei:
            await c.poll(tid)
        assert ei.value.code == "dropped"

        # superseded: the owning process flushes and advances past the
        # ring's horizon before the client polls
        t_old = await c.submit("old", user_batch(1))
        srv.flush()
        srv.advance_window()
        srv.advance_window()
        with pytest.raises(TransportError) as ei:
            await c.poll(t_old)
        assert ei.value.code == "superseded"

        # evicted: a done ticket without its handle (as after a restart)
        # whose user left the head cache
        srv2 = _server(head_cache=1)
        ts2 = await TransportServer(srv2, flush_ms=60_000.0).start()
        c2 = await AsyncTransportClient("127.0.0.1", ts2.port).connect()
        t_a = await c2.submit("a", user_batch(2))
        srv2.flush()
        srv2.submit("b", user_batch(3))
        srv2.flush()                             # "a" leaves the cache
        next(iter(ts2._conns)).records[t_a].ticket.head = None
        with pytest.raises(TransportError) as ei:
            await c2.poll(t_a)
        assert ei.value.code == "evicted"

        srv3 = _server(user_cap=1)
        srv3.batcher.user_cap = None             # the ring is the authority
        ts3 = await TransportServer(srv3, flush_ms=60_000.0,
                                    max_inflight=8).start()
        c3 = await AsyncTransportClient("127.0.0.1", ts3.port).connect()
        t_local = srv3.submit("heavy", user_batch(1))
        t3 = await c3.submit("heavy", user_batch(2))
        await c3.flush()
        assert t_local.status == "done"
        with pytest.raises(TransportError) as ei:
            await c3.poll(t3)
        assert ei.value.code == "capped"
        for cl in (c, c2, c3):
            await cl.close()
        for s in (ts, ts2, ts3):
            await s.stop()

    run(go)


def test_backpressure_busy_server_scope():
    async def go():
        srv = _server()
        ts = await TransportServer(srv, flush_ms=60_000.0,
                                   max_inflight=2).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        t0 = await c.submit("u0", user_batch(0))
        t1 = await c.submit("u1", user_batch(1))
        with pytest.raises(TransportBusy) as ei:
            await c.submit("u2", user_batch(2))
        assert ei.value.scope == "server" and ei.value.open_tickets == 2
        assert ts.stats["busy"] == 1
        await c.flush()
        assert (await c.poll(t0, wait_ms=1_000)) is not None
        assert (await c.poll(t1, wait_ms=1_000)) is not None
        await c.submit("u2", user_batch(2))      # accepted now
        await c.close()
        await ts.stop()

    run(go)


def test_backpressure_busy_connection_and_user_scopes():
    async def go():
        srv = _server(user_cap=1)
        ts = await TransportServer(srv, flush_ms=60_000.0,
                                   conn_inflight=2).start()
        c1 = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        c2 = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        await c1.submit("shared", user_batch(0))
        for c in (c1, c2):                       # across connections too
            with pytest.raises(TransportBusy) as ei:
                await c.submit("shared", user_batch(1))
            assert ei.value.scope == "user"
        await c1.flush()                         # now admitted by the ring
        assert srv.ring.admitted_rows("shared") == 1
        with pytest.raises(TransportBusy) as ei:
            await c2.submit("shared", user_batch(2))
        assert ei.value.scope == "user"
        await c1.submit("other", user_batch(2))
        with pytest.raises(TransportBusy) as ei:
            await c1.submit("third", user_batch(3))
        assert ei.value.scope == "connection"
        await c2.submit("fourth", user_batch(4))
        await c1.close()
        await c2.close()
        await ts.stop()

    run(go)


def test_dead_connection_releases_inflight_slots():
    async def go():
        srv = _server()
        ts = await TransportServer(srv, flush_ms=60_000.0,
                                   max_inflight=2).start()
        c1 = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        await c1.submit("u0", user_batch(0))
        await c1.submit("u1", user_batch(1))
        await c1.close()                         # frees both slots
        for _ in range(100):
            if ts._inflight == 0:
                break
            await asyncio.sleep(0.01)
        c2 = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        await c2.submit("u2", user_batch(2))     # no BUSY
        await c2.close()
        await ts.stop()

    run(go)


def test_unknown_ops_and_tickets_are_typed_errors():
    async def go():
        srv = _server()
        ts = await TransportServer(srv).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        with pytest.raises(TransportError) as ei:
            await c._rpc({"op": "NOPE"})
        assert ei.value.code == "unknown_op"
        with pytest.raises(TransportError) as ei:
            await c.poll(12345)
        assert ei.value.code == "unknown_ticket"
        with pytest.raises(TransportError) as ei:
            await c.head("nobody")
        assert ei.value.code == "unknown_user"
        with pytest.raises(TransportError) as ei:
            await c.submit("u", user_batch(0), mode="Z")
        assert ei.value.code == "bad_mode"
        with pytest.raises(TransportError) as ei:
            await c._rpc({"op": "SUBMIT", "mode": "C"})     # no user
        assert ei.value.code == "bad_request"
        t_ok = await c.submit("fine", user_batch(1))
        with pytest.raises(TransportError) as ei:
            await c._rpc({"op": "SUBMIT", "user": "u", "mode": "C"},
                         b"not-an-npz")
        assert ei.value.code == "bad_request"
        assert ts.stats["failed_flushes"] == 0
        await c.flush()
        assert (await c.poll(t_ok, wait_ms=1_000)) is not None
        await c.close()
        await ts.stop()

    run(go)


def test_poisoned_batch_fails_typed_and_server_survives():
    async def go():
        srv = _server(max_pending=2)
        ts = await TransportServer(srv, flush_ms=60_000.0).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        t_ok = await c.submit("good", user_batch(0))
        bad = {"wrong_key": np.zeros((3, 3), np.float32)}
        with pytest.raises(TransportError) as ei:
            await c.submit("evil", bad)          # fills the queue: flush
        assert ei.value.code == "server_error"
        with pytest.raises(TransportError) as ei:
            await c.poll(t_ok, wait_ms=1_000)
        assert ei.value.code == "server_error"
        assert ts.stats["failed_flushes"] == 1
        t2 = await c.submit("good", user_batch(1))
        await c.flush()
        assert (await c.poll(t2, wait_ms=1_000)) is not None
        await c.close()
        await ts.stop()

    run(go)


def test_codec_negotiation_and_int8_bodies():
    async def go():
        srv = _server(max_pending=2, delta_dtype="int8", modes=("C",))
        ts = await TransportServer(srv, flush_ms=20.0).start()
        cq = await AsyncTransportClient("127.0.0.1", ts.port,
                                        codec="int8").connect()
        cf = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        tq = await cq.submit("uq", user_batch(1))
        tf = await cf.submit("uf", user_batch(2))
        hq = await cq.poll(tq, wait_ms=10_000)
        hf = await cf.poll(tf, wait_ms=10_000)
        assert (cq.last_codec, cf.last_codec) == ("int8", "fp32")
        np.testing.assert_allclose(hq["w"], hf["w"], atol=0.05)
        # the fp32 client's body is the in-process head's, bit for bit
        _bitwise_equal(hf, srv.head("uf"))
        bq = (await cq._rpc({"op": "HEAD", "user": "uq", "codec_ok": True}))
        bf = (await cq._rpc({"op": "HEAD", "user": "uq"}))
        assert (bq[0]["codec"], bf[0]["codec"]) == ("int8", "fp32")
        # at this size the npz overhead outweighs the codes: check the
        # layout (chip_smoke.py's (q1) checks the ratio at 256 x 256)
        with np.load(io.BytesIO(bq[1])) as zq, \
                np.load(io.BytesIO(bf[1])) as zf:
            assert zq["w"].dtype == np.int8 and "__q8s__:w" in zq.files
            assert zf["w"].dtype == np.float32 and len(zf.files) == 2
        stats = await cq.stats()
        assert (stats["delta_codec"], stats["wire_codec"]) == ("int8",
                                                               "int8")
        assert stats["host_materializations"] == 0
        await cq.close()
        await cf.close()
        await ts.stop()

        srv = _server(max_pending=1)             # an fp32 server
        ts = await TransportServer(srv, flush_ms=20.0).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port,
                                       codec="int8").connect()
        assert await c.poll(await c.submit("u", user_batch(3)),
                            wait_ms=10_000) is not None
        assert c.last_codec == "fp32"            # the server's codec wins
        await c.close()
        await ts.stop()
        with pytest.raises(ValueError, match="wire_codec"):
            TransportServer(srv, wire_codec="fp16")

    run(go)


def test_subset_negotiation_and_heads():
    ref = _server(personal_subset=("b",))
    t_ref = ref.submit("u0", user_batch(0))
    ref.flush()
    expected = ref.poll(t_ref)

    async def go():
        srv = _server(personal_subset=("b",))
        ts = await TransportServer(srv, flush_ms=60_000.0).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        for hdr in ({"op": "SUBMIT", "user": "x", "mode": "C"},
                    {"op": "POLL", "ticket": 0},
                    {"op": "HEAD", "user": "x"}):
            with pytest.raises(TransportError) as ei:
                await c._rpc(hdr, T.encode_pytree(user_batch(0))
                             if hdr["op"] == "SUBMIT" else b"")
            assert ei.value.code == "subset_unsupported"
        tid = await c.submit("u0", user_batch(0))
        await c.flush()
        head = await c.poll(tid, wait_ms=10_000)
        assert c.last_subset == ["b"]
        again = await c.head("u0")
        h, _ = await c._rpc({"op": "STATS"})
        await c.close()
        await ts.stop()

        full = _server()                         # a full-model server
        ts = await TransportServer(full, flush_ms=60_000.0).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        ok, _ = await c._rpc({"op": "SUBMIT", "user": "u", "mode": "C"},
                             T.encode_pytree(user_batch(0)))
        await c.flush()
        whole = await c.poll(int(ok["ticket"]), wait_ms=10_000)
        assert set(whole) == {"b", "w"} and c.last_subset is None
        await c.close()
        await ts.stop()
        return head, again, h

    head, again, stats_reply = run(go)
    assert set(head) == {"b"} and stats_reply["subset"] == ["b"]
    _bitwise_equal(head, expected)
    _bitwise_equal(again, expected)


# -- (c) clean shutdown ------------------------------------------------------

def test_clean_shutdown_with_a_poll_parked():
    """The reference's stop() awaits ``wait_closed`` first, which under
    Python >= 3.12.1 waits for every connection; the port's closes them
    first and returns with a handler parked in a 60 s POLL."""
    async def go():
        srv = _server()
        ts = await TransportServer(srv, flush_ms=60_000.0).start()
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        assert (await c.stats())["window"] == 0
        c2 = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        tid = await c2.submit("u", user_batch(0))
        waiter = asyncio.ensure_future(c2.poll(tid, wait_ms=60_000))
        await asyncio.sleep(0.05)
        t0 = time.perf_counter()
        await ts.stop()
        took = time.perf_counter() - t0
        with pytest.raises((ConnectionError, OSError)):
            await c.stats()
        with pytest.raises((ConnectionError, OSError, TransportError)):
            await waiter
        await c.close()
        await c2.close()
        assert not ts._tasks and not ts._writers
        return took

    assert run(go) < 2.0


def test_serve_forever_stops_when_cancelled():
    async def go():
        ts = TransportServer(_server())
        task = asyncio.ensure_future(ts.serve_forever())
        while ts.port is None:
            await asyncio.sleep(0.01)
        c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        await c.stats()
        t0 = time.perf_counter()
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        took = time.perf_counter() - t0
        with pytest.raises((ConnectionError, OSError)):
            await c.stats()
        await c.close()
        return took

    assert run(go) < 2.0


# -- (d) the two packages on one loop ----------------------------------------

def test_reference_client_against_port_server_and_back():
    jref = _jserver()
    t = jref.submit("u0", user_batch(0))
    jref.flush()
    j_expected = jax.tree.map(np.asarray, jref.poll(t))
    tref = _server()
    t = tref.submit("u1", user_batch(1))
    tref.flush()
    t_expected = tref.poll(t)

    async def go():
        ts = await TransportServer(_server(), flush_ms=20.0).start()
        jc = await JT.AsyncTransportClient("127.0.0.1", ts.port).connect()
        got_j = await jc.poll(await jc.submit("u0", user_batch(0)),
                              wait_ms=10_000)
        again = await jc.head("u0")
        jstats = await jc.stats()
        with pytest.raises(JT.TransportError) as ei:
            await jc.poll(999)
        assert ei.value.code == "unknown_ticket"
        await jc.close()
        await ts.stop()

        js = await JT.TransportServer(_jserver(), flush_ms=20.0).start()
        tc = await AsyncTransportClient("127.0.0.1", js.port).connect()
        got_t = await tc.poll(await tc.submit("u1", user_batch(1)),
                              wait_ms=10_000)
        tstats = await tc.stats()
        await tc.close()                         # before the JAX stop()
        await asyncio.wait_for(js.stop(), 10)
        return got_j, again, jstats, got_t, tstats

    got_j, again, jstats, got_t, tstats = run(go)
    _close(got_j, j_expected)
    _bitwise_equal(again, got_j)
    _close(t_expected, got_t)
    assert jstats["host_materializations"] == tstats[
        "host_materializations"] == 0
    assert jstats["cohort_calls"] == tstats["cohort_calls"] == 1


# -- (e) a second OS process -------------------------------------------------

CLIENT_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from repro_torch.serving.transport import TransportClient

    port, out = int(sys.argv[1]), sys.argv[2]
    rng = np.random.RandomState(7)
    batch = {"x": rng.randn(8, 5).astype(np.float32),
             "y": rng.randint(0, 4, 8).astype(np.int32)}
    with TransportClient("127.0.0.1", port, timeout=30.0) as c:
        head = c.poll(c.submit("remote-user", batch), wait_ms=20_000)
        if head is None:
            sys.exit("poll timed out")
        again = c.head("remote-user")
        if not all(np.array_equal(head[k], again[k]) for k in head):
            sys.exit("HEAD differs from POLL")
        if c.stats()["host_materializations"] != 0:
            sys.exit("host materializations")
        np.savez(out, **head)
""")


def test_second_process_personalizes_over_the_socket(tmp_path):
    script = tmp_path / "client.py"
    script.write_text(CLIENT_SCRIPT)
    out = tmp_path / "head.npz"
    rng = np.random.RandomState(7)
    batch = {"x": rng.randn(8, 5).astype(np.float32),
             "y": rng.randint(0, 4, 8).astype(np.int32)}
    ref = _server()
    t_ref = ref.submit("remote-user", batch)
    ref.flush()
    expected = ref.poll(t_ref)

    async def go():
        ts = await TransportServer(_server(), flush_ms=50.0).start()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = await asyncio.create_subprocess_exec(
            sys.executable, str(script), str(ts.port), str(out), env=env,
            stderr=asyncio.subprocess.PIPE)
        try:
            _, err = await asyncio.wait_for(proc.communicate(), 60)
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
        await ts.stop()
        return proc.returncode, err

    rc, err = run(go, limit=70.0)
    assert rc == 0, err.decode()[-2000:]
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    _bitwise_equal(got, expected)


def test_serve_listen_raises_without_a_gpu(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "mamba2-130m", "--smoke", "--listen", "0",
                    "--serve-seconds", "1"])


def test_serve_listen_child_stops_with_a_connection_open(listen_child):
    proc = listen_child["proc"]
    out, err = proc.communicate(timeout=60)
    took = time.perf_counter() - listen_child["t_line"]
    assert proc.returncode == 0, err[-2000:]
    assert took < SERVE_S + 10
    if listen_child["client"] is not None:     # the drive test ran
        assert "transport stopped after 1 connections / 4 frames " \
               "(host_materializations=0, launches" in out
