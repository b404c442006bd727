"""Asyncio socket front-end for
:class:`repro_torch.serving.PersonalizationServer`, as in
``src/repro/serving/transport.py``: the same wire protocol (version 1),
byte for byte, so a client of either package talks to a server of either
package.

:class:`TransportServer` makes the server network-addressable and keeps its
micro-batching: every connection's SUBMIT frames land in the same
:class:`repro_torch.serving.batcher.MicroBatcher` queue and coalesce into
the same pow2-bucketed cohort calls.

Wire protocol (version 1), length-prefixed JSON + binary frames::

    frame  := u32 len(rest) | u32 len(header) | header | body
    header := UTF-8 JSON object; "op" selects the operation
    body   := npz-encoded tree (numpy ``savez`` of the checkpoint store's
              ``path/to/leaf`` flat layout) or empty

All u32 are big-endian.  Client → server ops and their replies:

    SUBMIT {user, mode, subset_ok?, codec_ok?}  + npz(batch)
                                       → OK {ticket, window}
                                         | BUSY {scope, open}
    POLL   {ticket, wait_ms?, subset_ok?}
                                       → OK {status:"queued"}
                                         | OK {status:"done", subset?,
                                               codec} + npz(head)
                                         | ERR {code: dropped|capped|
                                                evicted|superseded, error}
    HEAD   {user, subset_ok?, codec_ok?} → OK {subset?, codec} + npz(head)
                                         | ERR unknown_user
    STATS  {}                          → OK {stats: {...}, subset?}
    FLUSH  {}                          → OK {served}
    ADVANCE{}                          → OK {window}

Subset negotiation: a server that personalizes a ``personal_subset`` sends
*subset trees* (merge them over the backbone with
:func:`repro_torch.core.merge_subset`); a client that does not declare
``subset_ok: true`` on SUBMIT/POLL/HEAD gets ``ERR subset_unsupported``,
and replies with a subset body stamp the resolved leaf paths in the
header's ``subset`` key (clients record it as ``.last_subset``).

Codec negotiation: npz bodies may carry float leaves as symmetric-absmax
int8 codes plus one f32 scale per leaf under ``__q8s__:<key>``, so an int8
body describes itself.  An int8-banking server (or ``wire_codec="int8"``)
sends int8 head bodies only to clients that declared ``codec_ok: true``
(at SUBMIT; HEAD negotiates per request); others get fp32 bodies, and
replies stamp the body's codec in ``codec`` (clients record
``.last_codec``).  A client built with ``codec="int8"`` also quantizes its
SUBMIT bodies.

Flushing: a SUBMIT that fills the server's ``max_pending`` queue flushes
synchronously; a partial queue is flushed by a ``flush_ms`` timer armed at
the first queued request.  ``window_ms`` optionally drives
``advance_window`` on a wall-clock timer.

Backpressure: ``max_inflight`` bounds the server's open tickets,
``conn_inflight`` one connection's, and with the server's ``user_cap`` set
a user's queued submissions per window are refused at the door; each
refusal is a ``BUSY`` frame naming its scope (``server`` / ``connection`` /
``user``), which clients raise as :class:`TransportBusy`.

Clients: :class:`TransportClient` (blocking, for any other process) and
:class:`AsyncTransportClient` (asyncio).  Frames on one connection are
handled in order: one RPC at a time per connection.

Heads leave the card here: a flush's served heads are gathered on the
device once per head bank and copied to the host once per leaf, then cut
per ticket in numpy.  That is the wire's host boundary, not a bank
materialization: ``stats["host_materializations"]`` stays 0.

:meth:`TransportServer.stop` closes every connection and cancels every
handler before it waits for the listening server, with a bound on each
wait, so it returns while a client is still connected (since Python
3.12.1, ``asyncio.Server.wait_closed`` waits for every open connection).

``python -m repro_torch.serving.transport [--device cpu]`` runs a loopback
selftest on the card unless asked for the CPU.
"""
from __future__ import annotations

import asyncio
import io
import json
import socket
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import (_flatten, _unflatten, pack_dtypes,
                                          unpack_dtypes)
from repro_torch.serving.server import _rows_of
from repro_torch.tree import tree_leaves, tree_map

PROTOCOL_VERSION = 1
WIRE_CODECS = ("fp32", "int8")
# per-leaf wire-quantization scale marker: like the checkpoint store's
# ``__dt__:`` markers, the ``:`` keeps it disjoint from every data key
Q8_KEY_PREFIX = "__q8s__:"
_U32 = struct.Struct("!I")
# reject absurd frames instead of buffering our way to OOM
MAX_FRAME_BYTES = 1 << 28
# each wait of stop(): the handlers' ends, then the listening server's
_STOP_WAIT_S = 0.5


class ProtocolError(RuntimeError):
    """Malformed frame or header (framing, not application, errors)."""


class TransportError(RuntimeError):
    """Application-level ERR reply surfaced client-side.

    ``code`` mirrors the server's refusal cause: ``dropped`` (staleness
    past tau_max), ``capped`` (per-window fairness cap), ``superseded``
    (the ticket's ring window retired before it was polled), ``evicted``
    (LRU head-cache pressure on a handle-less ticket),
    ``subset_unsupported`` (the server serves personal-subset heads and
    the client did not declare ``subset_ok``), ``unknown_user`` /
    ``unknown_ticket`` / ``bad_request``.
    """

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class TransportBusy(TransportError):
    """BUSY reply: the server refused to queue more work.  ``scope`` says
    which bound tripped (``server`` / ``connection`` / ``user``); back off
    and retry, nothing was queued."""

    def __init__(self, scope: str, open_tickets: int):
        super().__init__(
            "busy", f"backpressure at scope={scope!r} "
                    f"(open={open_tickets}); retry later")
        self.scope = scope
        self.open_tickets = open_tickets


# ---------------------------------------------------------------------------
# codec: npz trees + length-prefixed frames
# ---------------------------------------------------------------------------

def _host(x):
    """One leaf on the host: a numpy array, or a CPU tensor for bf16, which
    numpy lacks (``pack_dtypes`` writes its bits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(x)


def encode_pytree(tree, codec: str = "fp32") -> bytes:
    """Tree → npz bytes in the checkpoint store's flat key layout, the same
    bytes the reference writes for the same values.  Tensors on the card
    come to the host here: the wire is a host boundary (not a DeltaBank
    materialization).

    Non-float dtypes round-trip exactly in every codec: bf16 leaves as bit
    patterns plus ``__dt__:`` markers, integer leaves natively.
    ``codec="int8"`` also rewrites each f32/f64 leaf as int8 codes plus one
    f32 scale under ``__q8s__:<key>`` (symmetric absmax), so the decoder
    needs no negotiated state.
    """
    if codec not in WIRE_CODECS:
        raise ValueError(f"codec must be one of {WIRE_CODECS}, "
                         f"got {codec!r}")
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    if codec == "int8":
        out = {}
        for key, arr in flat.items():
            if isinstance(arr, np.ndarray) and arr.dtype.kind == "f" \
                    and arr.dtype.itemsize >= 4:
                x = arr.astype(np.float32)
                scale = np.float32(np.max(np.abs(x)) / 127.0
                                   if x.size else 0.0)
                safe = scale if scale > 0 else np.float32(1.0)
                out[key] = np.clip(np.round(x / safe),
                                   -127, 127).astype(np.int8)
                out[Q8_KEY_PREFIX + key] = scale
            else:
                out[key] = arr
        flat = out
    buf = io.BytesIO()
    np.savez(buf, **pack_dtypes(flat))
    return buf.getvalue()


def decode_pytree(data: bytes):
    """npz bytes → tree of numpy arrays (bf16 leaves as CPU tensors).  The
    inverse of :func:`encode_pytree`: ``__dt__:`` markers restore bf16,
    ``__q8s__:`` markers dequantize int8 leaves."""
    with np.load(io.BytesIO(data)) as z:
        flat = unpack_dtypes({k: z[k] for k in z.files})
    scales = {k[len(Q8_KEY_PREFIX):]: flat[k] for k in flat
              if k.startswith(Q8_KEY_PREFIX)}
    if scales:
        flat = {k: v for k, v in flat.items()
                if not k.startswith(Q8_KEY_PREFIX)}
        for key, scale in scales.items():
            flat[key] = flat[key].astype(np.float32) * np.float32(scale)
    return _unflatten(flat)


def pack_frame(header: Dict, body: bytes = b"") -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return (_U32.pack(4 + len(hdr) + len(body)) + _U32.pack(len(hdr))
            + hdr + body)


def split_frame(payload: bytes) -> Tuple[Dict, bytes]:
    if len(payload) < 4:
        raise ProtocolError("truncated frame")
    (hlen,) = _U32.unpack_from(payload)
    if 4 + hlen > len(payload):
        raise ProtocolError("header length exceeds frame")
    try:
        header = json.loads(payload[4:4 + hlen])
    except ValueError as e:
        raise ProtocolError(f"bad header JSON: {e}") from None
    if not isinstance(header, dict):
        raise ProtocolError("header must be a JSON object")
    return header, payload[4 + hlen:]


async def read_frame(reader: asyncio.StreamReader
                     ) -> Optional[Tuple[Dict, bytes]]:
    """One frame off an asyncio stream; None on clean EOF."""
    try:
        raw = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (n,) = _U32.unpack(raw)
    if n < 4 or n > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {n} out of bounds")
    try:
        payload = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return split_frame(payload)


def _no_nagle(sock_like) -> None:
    """Frames are small request/reply pairs: Nagle + delayed ACK would add
    ~40ms per RPC on loopback, drowning the micro-batch win."""
    try:
        sock_like.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except (OSError, AttributeError):
        pass


def _jsonable(stats: Dict) -> Dict:
    """The server's stats as JSON values: strings kept, 0-d tensors and
    numpy scalars as numbers, anything else dropped."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            v = v.item()
        if isinstance(v, str):
            out[k] = v          # e.g. delta_codec
        elif isinstance(v, (float, np.floating)):
            out[k] = float(v)
        elif isinstance(v, (int, np.integer)):
            out[k] = int(v)
    return out


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _Record:
    """One open ticket: the server-side Ticket plus the event POLL waits
    on (set when a flush turns the ticket terminal), for served tickets
    the pre-encoded npz reply body, and for tickets lost to a poisoned
    flush the failure message (see ``TransportServer._resolve`` /
    ``_safe_call``)."""

    __slots__ = ("ticket", "event", "user", "encoded", "failed", "codec")

    def __init__(self, ticket, user, codec: str = "fp32"):
        self.ticket = ticket
        self.event = asyncio.Event()
        self.user = user
        self.encoded: Optional[bytes] = None
        self.failed: Optional[str] = None
        # reply-body codec negotiated at SUBMIT: "int8" only when the
        # server runs a quantized wire AND this client declared codec_ok
        self.codec = codec


class _Conn:
    __slots__ = ("records", "next_tid")

    def __init__(self):
        self.records: Dict[int, _Record] = {}
        self.next_tid = 0


class TransportServer:
    """Bridges concurrent socket connections into one
    :class:`PersonalizationServer`'s submit/flush/poll surface.

    Parameters
    ----------
    server        : the PersonalizationServer being fronted
    host, port    : bind address (``port=0`` = ephemeral; ``self.port``
                    holds the bound port after :meth:`start`)
    flush_ms      : deadline flush: a partial queue older than this is
                    flushed by timer (a full ``max_pending`` queue flushes
                    synchronously inside submit, as in-process)
    window_ms     : optional wall-clock aggregation-window timer driving
                    ``advance_window`` (None = windows advance only via
                    ADVANCE frames or the owning process)
    max_inflight  : server-wide bound on open tickets → ``BUSY server``
    conn_inflight : per-connection bound on open tickets → ``BUSY
                    connection``
    wire_codec    : head-body codec for ``codec_ok`` clients; defaults to
                    the server's ``delta_dtype``
    per-user      : with the fronted server's ``user_cap`` set, a user's
                    *queued* submissions in the current window are bounded
                    by it → ``BUSY user``

    Everything runs on one event loop; a flush's cohort call blocks it,
    which is the micro-batch amortization the serving stack is built on.
    """

    def __init__(self, server, *, host: str = "127.0.0.1", port: int = 0,
                 flush_ms: float = 10.0, window_ms: Optional[float] = None,
                 max_inflight: int = 256, conn_inflight: int = 64,
                 wire_codec: Optional[str] = None):
        self.server = server
        self.host = host
        spec = getattr(server, "personal_subset", None)
        # resolved once: the leaf paths stamped into subset reply headers
        self._subset_desc = spec.descriptor(server.params) \
            if spec is not None else None
        if wire_codec is None:
            wire_codec = getattr(server, "delta_dtype", "fp32")
        if wire_codec not in WIRE_CODECS:
            raise ValueError(f"wire_codec must be one of {WIRE_CODECS}, "
                             f"got {wire_codec!r}")
        self.wire_codec = wire_codec
        self.requested_port = port
        self.flush_ms = flush_ms
        self.window_ms = window_ms
        self.max_inflight = max_inflight
        self.conn_inflight = conn_inflight
        self.port: Optional[int] = None
        self._srv: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._writers: set = set()
        self._tasks: set = set()
        self._inflight = 0
        self._flush_handle = None
        self._window_handle = None
        self.stats = {"connections": 0, "frames": 0, "busy": 0,
                      "timer_flushes": 0, "window_advances": 0,
                      "failed_flushes": 0}

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "TransportServer":
        self._srv = await asyncio.start_server(self._handle, self.host,
                                               self.requested_port)
        self.port = self._srv.sockets[0].getsockname()[1]
        if self.window_ms is not None:
            self._window_handle = asyncio.get_running_loop().call_later(
                self.window_ms / 1e3, self._on_window_timer)
        return self

    async def stop(self) -> None:
        """Clean shutdown: stop listening, drop connections, cancel timers.
        Queued-but-unflushed requests stay in the fronted server's queue.

        The connections go first: every writer is closed and every handler
        cancelled (a handler parked in a long POLL wait is not woken by its
        writer closing), and only then is the listening server awaited,
        which since Python 3.12.1 waits for every open connection.  Each
        wait is bounded, so stop() returns even if a peer stalls."""
        for h in (self._flush_handle, self._window_handle):
            if h is not None:
                h.cancel()
        self._flush_handle = self._window_handle = None
        if self._srv is not None:
            self._srv.close()
        writers = list(self._writers)
        for w in writers:
            w.close()
        tasks = list(self._tasks)
        for t in tasks:
            t.cancel()
        if tasks:
            _, pending = await asyncio.wait(tasks, timeout=_STOP_WAIT_S)
            if pending:
                # a peer that reads nothing keeps a closing writer open
                for w in writers:
                    w.transport.abort()
        if self._srv is not None:
            try:
                await asyncio.wait_for(self._srv.wait_closed(),
                                       _STOP_WAIT_S)
            except asyncio.TimeoutError:
                pass

    async def serve_forever(self, *, announce: bool = False) -> None:
        """Serve until cancelled, then :meth:`stop`.  The listening server
        already serves from :meth:`start`; its own ``serve_forever`` is not
        awaited, since on cancellation it awaits ``wait_closed`` before any
        connection is closed."""
        if self._srv is None:
            await self.start()
        if announce:
            print(f"transport: listening on {self.host}:{self.port} "
                  f"(wire protocol v{PROTOCOL_VERSION})", flush=True)
        try:
            await asyncio.get_running_loop().create_future()
        finally:
            await self.stop()

    # -- timers ------------------------------------------------------------

    def _sync_flush_timer(self) -> None:
        """The deadline belongs to the oldest queued request: armed when
        the queue goes non-empty, cancelled the moment a flush empties it
        (a stale timer would fire mid-next-batch and split its cohort)."""
        if len(self.server.batcher):
            if self._flush_handle is None:
                self._flush_handle = asyncio.get_running_loop().call_later(
                    self.flush_ms / 1e3, self._on_flush_timer)
        elif self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None

    def _on_flush_timer(self) -> None:
        self._flush_handle = None
        self.stats["timer_flushes"] += 1
        self._safe_call(self.server.flush)
        self._resolve()

    def _on_window_timer(self) -> None:
        self.stats["window_advances"] += 1
        self._safe_call(self.server.advance_window)
        self._resolve()
        self._sync_flush_timer()
        self._window_handle = asyncio.get_running_loop().call_later(
            self.window_ms / 1e3, self._on_window_timer)

    def _safe_call(self, fn) -> Tuple[Optional[object], Optional[str]]:
        """Run a flush/advance without letting one poisoned batch kill
        the event loop: a cohort call raising (bad shapes, missing keys:
        remote clients send arbitrary trees) has already consumed the
        drained queue, so every still-queued ticket's batch is gone.
        Those tickets fail with the cause; the server keeps serving."""
        try:
            return fn(), None
        except Exception as e:      # noqa: BLE001 — remote input boundary
            msg = f"{type(e).__name__}: {e}"
            self._fail_queued(msg)
            return None, msg

    def _fail_queued(self, msg: str) -> None:
        self.stats["failed_flushes"] += 1
        for conn in self._conns:
            for rec in conn.records.values():
                if rec.ticket.status == "queued" \
                        and not rec.event.is_set():
                    rec.failed = msg
                    rec.event.set()

    def _resolve(self) -> None:
        """Wake every POLL waiter whose ticket a flush just turned
        terminal, and batch the response path: the heads a flush served are
        gathered once per head bank (``Ticket.head`` is the ticket's own
        ``(heads, row)``, so an older ticket's body is never the user's
        newest head), each leaf is copied to the host once, and each
        ticket's npz is cut from those copies in numpy.

        Refused tickets (dropped/capped), handle-less done tickets (the
        per-POLL fallback resolves them) and tickets whose window retired
        (POLL reports them superseded) carry no body here."""
        done = []
        horizon = self.server.window - self.server.ring.windows + 1
        for conn in self._conns:
            for rec in conn.records.values():
                if rec.ticket.status != "queued" and not rec.event.is_set():
                    if rec.ticket.status == "done" \
                            and rec.ticket.head is not None \
                            and rec.ticket.window >= horizon:
                        done.append(rec)
                    else:
                        rec.event.set()
        if not done:
            return
        groups: Dict[int, Tuple[object, list]] = {}
        for rec in done:
            heads, row = rec.ticket.head
            groups.setdefault(id(heads), (heads, []))[1].append((rec, row))
        for heads, pairs in groups.values():
            # fp32 banks gather rows of their head stack; the lazy
            # QuantizedHeads of int8 banking dequantize the gathered rows
            host = tree_map(_host, _rows_of(heads, [r for _, r in pairs]))
            for i, (rec, _) in enumerate(pairs):
                rec.encoded = encode_pytree(tree_map(lambda x: x[i], host),
                                            codec=rec.codec)
                rec.event.set()

    # -- connection handling -----------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = _Conn()
        _no_nagle(writer.get_extra_info("socket"))
        self._conns.add(conn)
        self._writers.add(writer)
        self._tasks.add(asyncio.current_task())
        self.stats["connections"] += 1
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                self.stats["frames"] += 1
                header, body = frame
                try:
                    reply, rbody = await self._dispatch(conn, header, body)
                except (ProtocolError, KeyError, TypeError,
                        ValueError) as e:
                    reply, rbody = {"op": "ERR", "code": "bad_request",
                                    "error": str(e)}, b""
                writer.write(pack_frame(reply, rbody))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, ProtocolError):
            pass
        finally:
            # a dead connection releases its open tickets (backpressure
            # slots must not leak); the server-side work still completes
            self._inflight -= len(conn.records)
            conn.records.clear()
            self._conns.discard(conn)
            self._writers.discard(writer)
            self._tasks.discard(asyncio.current_task())
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _dispatch(self, conn: _Conn, header: Dict,
                        body: bytes) -> Tuple[Dict, bytes]:
        op = header.get("op")
        if op == "SUBMIT":
            return self._op_submit(conn, header, body)
        if op == "POLL":
            return await self._op_poll(conn, header)
        if op == "HEAD":
            return self._op_head(header)
        if op == "STATS":
            return self._op_stats()
        if op == "FLUSH":
            served, err = self._safe_call(self.server.flush)
            self._resolve()
            self._sync_flush_timer()
            if err is not None:
                return {"op": "ERR", "code": "flush_failed",
                        "error": err}, b""
            return {"op": "OK", "served": served}, b""
        if op == "ADVANCE":
            # flush=false models a window boundary firing while requests
            # are still queued: they become stragglers, recomputed against
            # their stamped snapshot at the next flush
            _, err = self._safe_call(lambda: self.server.advance_window(
                flush=bool(header.get("flush", True))))
            self._resolve()
            self._sync_flush_timer()
            if err is not None:
                return {"op": "ERR", "code": "flush_failed",
                        "error": err}, b""
            return {"op": "OK", "window": self.server.window}, b""
        return {"op": "ERR", "code": "unknown_op",
                "error": f"unknown op {op!r}"}, b""

    def _subset_refusal(self, header: Dict) -> Optional[Tuple[Dict, bytes]]:
        """Typed ERR for pre-subset clients against a subset server: a head
        body would be a *partial* tree, which a client that has not declared
        ``subset_ok`` would take for the full model."""
        if self._subset_desc is not None and not header.get("subset_ok"):
            return {"op": "ERR", "code": "subset_unsupported",
                    "error": "server personalizes a param subset "
                             f"(subset={self._subset_desc}); declare "
                             "subset_ok and merge heads over the "
                             "backbone with merge_subset"}, b""
        return None

    def _op_submit(self, conn: _Conn, header: Dict,
                   body: bytes) -> Tuple[Dict, bytes]:
        refusal = self._subset_refusal(header)
        if refusal is not None:
            return refusal
        user = header["user"]
        mode = header.get("mode", "C")
        busy_scope = None
        if self._inflight >= self.max_inflight:
            busy_scope = "server"
        elif len(conn.records) >= self.conn_inflight:
            busy_scope = "connection"
        else:
            cap = self.server.ring.user_cap
            if cap is not None:
                # the user's consumed window budget = rows the ring
                # already admitted + submissions queued on ANY connection
                # (one user may fan out over several)
                window = self.server.window
                used = self.server.ring.admitted_rows(user)
                for cn in self._conns:
                    used += sum(1 for r in cn.records.values()
                                if r.user == user
                                and r.ticket.status == "queued"
                                and r.ticket.stamp == window)
                if used >= cap:
                    busy_scope = "user"
        if busy_scope is not None:
            self.stats["busy"] += 1
            return {"op": "BUSY", "scope": busy_scope,
                    "open": self._inflight}, b""
        if mode not in self.server.engines:
            return {"op": "ERR", "code": "bad_mode",
                    "error": f"mode {mode!r} not enabled; "
                             f"have {sorted(self.server.engines)}"}, b""
        # decode BEFORE the flush-capable submit: an undecodable body is a
        # bad frame from this one client, not a poisoned flush
        try:
            batch = decode_pytree(body)
        except Exception as e:      # noqa: BLE001 — remote input boundary
            return {"op": "ERR", "code": "bad_request",
                    "error": f"undecodable npz body: {e}"}, b""
        try:
            ticket = self.server.submit(user, batch, mode=mode)
        except Exception as e:      # noqa: BLE001 — the submit may have
            # auto-flushed a full queue with THIS batch as the poison: the
            # drain is spent, so fail the queued tickets and report it
            msg = f"{type(e).__name__}: {e}"
            self._fail_queued(msg)
            self._resolve()
            return {"op": "ERR", "code": "server_error", "error": msg}, b""
        tid = conn.next_tid
        conn.next_tid += 1
        codec = "int8" if (self.wire_codec == "int8"
                           and header.get("codec_ok")) else "fp32"
        conn.records[tid] = _Record(ticket, user, codec=codec)
        self._inflight += 1
        self._sync_flush_timer()
        self._resolve()
        return {"op": "OK", "ticket": tid, "window": ticket.stamp}, b""

    async def _op_poll(self, conn: _Conn,
                       header: Dict) -> Tuple[Dict, bytes]:
        refusal = self._subset_refusal(header)
        if refusal is not None:
            return refusal
        tid = int(header["ticket"])
        rec = conn.records.get(tid)
        if rec is None:
            return {"op": "ERR", "code": "unknown_ticket",
                    "error": f"no open ticket {tid}"}, b""
        wait_ms = header.get("wait_ms")
        if wait_ms and rec.ticket.status == "queued":
            try:
                await asyncio.wait_for(rec.event.wait(),
                                       float(wait_ms) / 1e3)
            except asyncio.TimeoutError:
                pass
        status = rec.ticket.status
        if rec.failed is not None:
            # the ticket's batch died with a poisoned flush: terminal
            del conn.records[tid]
            self._inflight -= 1
            return {"op": "ERR", "code": "server_error",
                    "error": f"request lost to a failed flush "
                             f"({rec.failed}); re-submit"}, b""
        if status == "queued":
            return {"op": "OK", "status": "queued"}, b""
        # terminal either way: the backpressure slot frees NOW
        del conn.records[tid]
        self._inflight -= 1
        ok = {"op": "OK", "status": "done", "window": self.server.window,
              "codec": rec.codec}
        if self._subset_desc is not None:
            ok["subset"] = self._subset_desc
        if rec.encoded is not None:
            return ok, rec.encoded
        try:
            head = self.server.poll(rec.ticket)
        except RuntimeError as e:
            if status in ("dropped", "capped"):
                code = status
            elif rec.ticket.window >= 0 and rec.ticket.window < (
                    self.server.window - self.server.ring.windows + 1):
                code = "superseded"
            else:
                code = "evicted"
            return {"op": "ERR", "code": code, "error": str(e)}, b""
        return ok, encode_pytree(head, codec=rec.codec)

    def _op_head(self, header: Dict) -> Tuple[Dict, bytes]:
        refusal = self._subset_refusal(header)
        if refusal is not None:
            return refusal
        user = header["user"]
        try:
            head = self.server.head(user)
        except KeyError:
            return {"op": "ERR", "code": "unknown_user",
                    "error": f"no cached head for {user!r}"}, b""
        codec = "int8" if (self.wire_codec == "int8"
                           and header.get("codec_ok")) else "fp32"
        ok = {"op": "OK", "user": user, "codec": codec}
        if self._subset_desc is not None:
            ok["subset"] = self._subset_desc
        return ok, encode_pytree(head, codec=codec)

    def _op_stats(self) -> Tuple[Dict, bytes]:
        stats = _jsonable(self.server.stats)
        stats.update({f"transport_{k}": v
                      for k, v in _jsonable(self.stats).items()})
        stats["transport_inflight"] = self._inflight
        stats["window"] = self.server.window
        stats["wire_codec"] = self.wire_codec
        ok = {"op": "OK", "stats": stats}
        if self._subset_desc is not None:
            ok["subset"] = self._subset_desc
        return ok, b""


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

def _check_reply(header: Dict) -> Dict:
    op = header.get("op")
    if op == "BUSY":
        raise TransportBusy(header.get("scope", "server"),
                            int(header.get("open", -1)))
    if op == "ERR":
        raise TransportError(header.get("code", "error"),
                             header.get("error", ""))
    if op != "OK":
        raise ProtocolError(f"unexpected reply op {op!r}")
    return header


class TransportClient:
    """Blocking client library, for any other OS process.

    One RPC at a time per connection; every method is a single
    request/reply frame pair.  ``poll`` returns None while the ticket is
    queued and the head tree once served; refusals raise
    :class:`TransportError` (``.code`` = dropped/capped/superseded/evicted)
    and backpressure raises :class:`TransportBusy`.

    Subset-aware: every request declares ``subset_ok``; ``last_subset``
    holds a reply's leaf-path descriptor (None for full-model servers).
    Codec-aware: ``codec="int8"`` declares ``codec_ok`` and quantizes this
    client's SUBMIT bodies; ``last_codec`` records each head reply's body
    codec.  Heads come back as numpy leaves (bf16 as CPU tensors).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 timeout: float = 30.0, codec: str = "fp32"):
        if codec not in WIRE_CODECS:
            raise ValueError(f"codec must be one of {WIRE_CODECS}, "
                             f"got {codec!r}")
        self.timeout = timeout
        self.codec = codec
        self.last_subset = None
        self.last_codec = None
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        _no_nagle(self._sock)

    def _recvn(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf.extend(chunk)
        return bytes(buf)

    def _rpc(self, header: Dict, body: bytes = b"",
             extra_wait_s: float = 0.0) -> Tuple[Dict, bytes]:
        self._sock.settimeout(self.timeout + extra_wait_s)
        self._sock.sendall(pack_frame(header, body))
        (n,) = _U32.unpack(self._recvn(4))
        if n < 4 or n > MAX_FRAME_BYTES:
            raise ProtocolError(f"frame length {n} out of bounds")
        rh, rb = split_frame(self._recvn(n))
        return _check_reply(rh), rb

    def submit(self, user, batch, mode: str = "C") -> int:
        h, _ = self._rpc({"op": "SUBMIT", "user": user, "mode": mode,
                          "subset_ok": True,
                          "codec_ok": self.codec == "int8"},
                         encode_pytree(batch, codec=self.codec))
        return int(h["ticket"])

    def poll(self, ticket: int, wait_ms: Optional[float] = None):
        header = {"op": "POLL", "ticket": int(ticket), "subset_ok": True}
        if wait_ms is not None:
            header["wait_ms"] = float(wait_ms)
        h, b = self._rpc(header,
                         extra_wait_s=(wait_ms or 0.0) / 1e3)
        if h["status"] != "done":
            return None
        self.last_subset = h.get("subset")
        self.last_codec = h.get("codec", "fp32")
        return decode_pytree(b)

    def head(self, user):
        h, b = self._rpc({"op": "HEAD", "user": user, "subset_ok": True,
                          "codec_ok": self.codec == "int8"})
        self.last_subset = h.get("subset")
        self.last_codec = h.get("codec", "fp32")
        return decode_pytree(b)

    def stats(self) -> Dict:
        h, _ = self._rpc({"op": "STATS"})
        return h["stats"]

    def flush(self) -> int:
        h, _ = self._rpc({"op": "FLUSH"})
        return int(h["served"])

    def advance(self, flush: bool = True) -> int:
        h, _ = self._rpc({"op": "ADVANCE", "flush": flush})
        return int(h["window"])

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "TransportClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncTransportClient:
    """Asyncio twin of :class:`TransportClient` (a load generator runs N of
    them on one event loop); subset- and codec-aware like it."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 codec: str = "fp32"):
        if codec not in WIRE_CODECS:
            raise ValueError(f"codec must be one of {WIRE_CODECS}, "
                             f"got {codec!r}")
        self.host = host
        self.port = port
        self.codec = codec
        self.last_subset = None
        self.last_codec = None
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> "AsyncTransportClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        _no_nagle(self._writer.get_extra_info("socket"))
        return self

    async def _rpc(self, header: Dict,
                   body: bytes = b"") -> Tuple[Dict, bytes]:
        self._writer.write(pack_frame(header, body))
        await self._writer.drain()
        frame = await read_frame(self._reader)
        if frame is None:
            raise ConnectionError("server closed the connection")
        rh, rb = frame
        return _check_reply(rh), rb

    async def submit(self, user, batch, mode: str = "C") -> int:
        h, _ = await self._rpc({"op": "SUBMIT", "user": user, "mode": mode,
                                "subset_ok": True,
                                "codec_ok": self.codec == "int8"},
                               encode_pytree(batch, codec=self.codec))
        return int(h["ticket"])

    async def poll(self, ticket: int, wait_ms: Optional[float] = None):
        header = {"op": "POLL", "ticket": int(ticket), "subset_ok": True}
        if wait_ms is not None:
            header["wait_ms"] = float(wait_ms)
        h, b = await self._rpc(header)
        if h["status"] != "done":
            return None
        self.last_subset = h.get("subset")
        self.last_codec = h.get("codec", "fp32")
        return decode_pytree(b)

    async def head(self, user):
        h, b = await self._rpc({"op": "HEAD", "user": user,
                                "subset_ok": True,
                                "codec_ok": self.codec == "int8"})
        self.last_subset = h.get("subset")
        self.last_codec = h.get("codec", "fp32")
        return decode_pytree(b)

    async def stats(self) -> Dict:
        h, _ = await self._rpc({"op": "STATS"})
        return h["stats"]

    async def flush(self) -> int:
        h, _ = await self._rpc({"op": "FLUSH"})
        return int(h["served"])

    async def advance(self, flush: bool = True) -> int:
        h, _ = await self._rpc({"op": "ADVANCE", "flush": flush})
        return int(h["window"])

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass


# ---------------------------------------------------------------------------
# loopback selftest
# ---------------------------------------------------------------------------

def _selftest(n_clients: int, rounds: int, device: str) -> None:
    from repro_torch.core import PersAFLConfig
    from repro_torch.serving import PersonalizationServer

    d = 16
    rng = np.random.RandomState(0)

    def loss(p, b):
        logp = torch.log_softmax(b["x"] @ p["w"] + p["b"], -1)
        return -torch.mean(logp.gather(-1, b["y"].long()[..., None]))

    params = {"w": (0.1 * rng.randn(d, 4)).astype(np.float32),
              "b": np.zeros((4,), np.float32)}
    pcfg = PersAFLConfig(option="C", lam=20.0, inner_steps=5,
                         inner_eta=0.05, beta=0.5)
    batches = [{"x": rng.randn(8, d).astype(np.float32),
                "y": rng.randint(0, 4, 8).astype(np.int32)}
               for _ in range(n_clients)]

    async def run() -> Dict:
        psrv = PersonalizationServer(params, loss, pcfg, modes=("C",),
                                     max_pending=n_clients, device=device)
        ts = await TransportServer(psrv, flush_ms=20.0,
                                   max_inflight=4 * n_clients).start()

        async def one_client(u: int) -> None:
            c = await AsyncTransportClient("127.0.0.1", ts.port).connect()
            for _ in range(rounds):
                tid = await c.submit(f"user{u}", batches[u], mode="C")
                head = await c.poll(tid, wait_ms=30_000)
                if head is None:
                    raise RuntimeError("poll timed out")
                if not all(np.all(np.isfinite(x))
                           for x in tree_leaves(head)):
                    raise RuntimeError("a served head is not finite")
            again = await c.head(f"user{u}")
            if not all(np.array_equal(a, b) for a, b in
                       zip(tree_leaves(head), tree_leaves(again))):
                raise RuntimeError("HEAD differs from the polled head")
            await c.close()

        await asyncio.gather(*(one_client(u) for u in range(n_clients)))
        admin = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        await admin.advance()
        stats = await admin.stats()
        await admin.close()
        await ts.stop()
        return stats

    stats = asyncio.run(run())
    if stats["host_materializations"] != 0 \
            or stats["cached_heads"] != n_clients:
        raise RuntimeError(f"transport selftest failed: {stats}")
    print(f"transport_selftest,clients={n_clients},rounds={rounds},"
          f"device={device},frames={stats['transport_frames']},"
          f"timer_flushes={stats['transport_timer_flushes']},"
          f"host_materializations={stats['host_materializations']},ok",
          flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="loopback transport selftest")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args()
    # under ``python -m`` this file runs as __main__ while the package
    # __init__ imported it once already: use the canonical module's classes
    from repro_torch.serving import transport as _canonical
    _canonical._selftest(args.clients, args.rounds, args.device)
