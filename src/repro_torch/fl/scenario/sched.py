"""Scalable event scheduling: the vectorized event stream and the device
scheduler, as in ``src/repro/fl/scenario/sched.py``.

Both backends draw from the same pure counter-based hash streams as the
heap (:mod:`repro_torch.fl.delays`), under one documented total event
order shared by every path:

    **(time, client_id, kind)** with ``KIND_DOWN(0) < KIND_UP(1)``

Two layers:

  * :class:`EventStream` — the host-vectorized float64 twin of the heap, a
    numpy copy of the reference's: delays for a whole chunk of cycles are
    drawn as ``[n_clients]`` arrays and merged by ``np.lexsort`` on the
    exact (time, client, kind) key; per-client times accumulate through
    the same float64 additions, in the same order, as the heap's scalar
    arithmetic, so the emitted event sequence is bit-equal to the heap.
    This is what ``FLRun(scheduler="device")`` replays: the simulation
    (policies, cohort calls, applies) is unchanged, only the scheduling
    data structure differs.
  * :class:`DeviceScheduler` — the cohort former for the
    10^5–10^6-client regime, with its state on ``device`` (the card unless
    the caller asks for the CPU): per-client next-download times (f32) and
    cycle counters (i32) as ``[n]`` tensors.  A window advances up to
    ``cycles_per_window`` cycles per client and forms its cohort, the
    first ``cohort_cap`` completions by arrival time.  The host sees only
    the ``[cohort_cap]`` id and time vectors and four scalar counters.  It
    follows the reference's jitted ``lax.scan`` operation by operation in
    float32, forming in float64 before the cast exactly the values the
    reference forms there; the float64 :class:`EventStream` is its host
    oracle (hash streams bit-identical, realized times equal to f32
    tolerance).
"""
from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fl.delays import (TAG_DOWN, TAG_DROP, TAG_UP,
                                   client_word_torch, hash_u01_torch)

KIND_DOWN = 0   # a client's download completed (it starts local compute)
KIND_UP = 1     # a client's upload landed at the server

_TWO_PI = 2.0 * np.pi


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float: a scalar operand that
    torch casts to a float32 tensor's type without a second rounding."""
    return float(np.float32(x))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add), the
    same bits on every backend.  The reference's compiler contracts its
    multiply-adds into FMAs; torch rounds each op, so the FMA is formed
    here in float64: the product of two float32 values is exact there, the
    sum is rounded to odd (an inexact sum with an even last bit moves one
    ulp toward the exact value, found by TwoSum), and rounding to odd in
    53 bits and then to nearest in 24 rounds correctly."""
    p = a.double() * (b.double() if torch.is_tensor(b) else float(b))
    c = c.double() if torch.is_tensor(c) else float(c)
    r = p + c
    z = r - p
    err = (p - (r - z)) + (c - z)
    even = (r.view(torch.int64) & 1) == 0
    r = torch.where((err != 0) & even,
                    torch.nextafter(r, torch.copysign(
                        torch.full_like(r, float("inf")), err)), r)
    return r.float()


def heap_events(model, n_clients: int):
    """The per-event heap scheduler as an infinite event generator, what
    ``FLRun(scheduler="heap")`` replays.

    Yields ``(t, client, kind, dropped, t_up)`` as :class:`EventStream`
    does, one Python heap operation and one scalar draw at a time.  Heap
    keys are ``(t, client, kind)``, the reference's deterministic total
    order on events."""
    heap: List[Tuple[float, int, int]] = []
    for i in range(n_clients):
        heapq.heappush(heap, (model.sample_download(i, 0.0), i, KIND_DOWN))
    while True:
        now, i, kind = heapq.heappop(heap)
        if kind == KIND_DOWN:
            dropped = model.drops(i)
            t_up = now + model.sample_upload(i, now)
            if dropped:
                heapq.heappush(
                    heap,
                    (t_up + model.sample_download(i, t_up), i, KIND_DOWN))
            else:
                heapq.heappush(heap, (t_up, i, KIND_UP))
            yield now, i, KIND_DOWN, dropped, t_up
        else:
            heapq.heappush(
                heap, (now + model.sample_download(i, now), i, KIND_DOWN))
            yield now, i, KIND_UP, False, now


class EventStream:
    """Host-vectorized generator of the heap's exact event sequence.

    Yields ``(t, client, kind, dropped, t_up)`` tuples in (time, client,
    kind) order, indefinitely — the consumer decides when to stop.  For a
    ``KIND_DOWN`` event ``t_up`` is the client's upload-completion time
    (the consumer's busy-interval bookkeeping); ``dropped`` marks a
    mid-round dropout cycle: no ``KIND_UP`` event will follow and the
    client's next download starts at ``t_up`` (the would-be upload
    duration is spent offline — realized timelines are identical whether
    or not a cycle drops, which keeps every scheduler backend aligned).
    """

    def __init__(self, model, *, chunk: int = 4):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.model = model
        self.chunk = chunk

    def events(self):
        model = self.model
        n = model.n_clients
        ids = np.arange(n)
        t = np.zeros(n, np.float64)       # next download start per client
        k = 0                             # cycle counter (lockstep chunks)
        empty_f = np.empty(0, np.float64)
        empty_i = np.empty(0, np.int64)
        empty_b = np.empty(0, bool)
        c_t, c_i, c_k = empty_f, empty_i, empty_i      # carried events
        c_d, c_u = empty_b, empty_f
        zeros_kind = np.zeros(n, np.int64)
        ones_kind = np.ones(n, np.int64)
        false_n = np.zeros(n, bool)
        while True:
            ts: List[np.ndarray] = [c_t]
            cs: List[np.ndarray] = [c_i]
            ks: List[np.ndarray] = [c_k]
            ds: List[np.ndarray] = [c_d]
            us: List[np.ndarray] = [c_u]
            for _ in range(self.chunk):
                dl = np.asarray(model.download_delay(ids, k, t), np.float64)
                t_arr = t + dl
                ul = np.asarray(model.upload_delay(ids, k, t_arr),
                                np.float64)
                t_up = t_arr + ul
                drop = np.asarray(model.drops_at(ids, k), bool)
                ts.append(t_arr)
                cs.append(ids)
                ks.append(zeros_kind)
                ds.append(drop)
                us.append(t_up)
                nd = ~drop
                ts.append(t_up[nd])
                cs.append(ids[nd])
                ks.append(ones_kind[nd])
                ds.append(false_n[nd])
                us.append(t_up[nd])
                t = t_up
                k += 1
            # every not-yet-generated event starts at some client's next
            # download start, so it lies strictly past min(t) (delays > 0):
            # events below that horizon are final and safe to emit sorted
            horizon = t.min()
            a_t = np.concatenate(ts)
            a_i = np.concatenate(cs)
            a_k = np.concatenate(ks)
            a_d = np.concatenate(ds)
            a_u = np.concatenate(us)
            emit = a_t < horizon
            order = np.lexsort((a_k[emit], a_i[emit], a_t[emit]))
            e_t, e_i = a_t[emit][order], a_i[emit][order]
            e_k, e_d = a_k[emit][order], a_d[emit][order]
            e_u = a_u[emit][order]
            for j in range(len(e_t)):
                yield (float(e_t[j]), int(e_i[j]), int(e_k[j]),
                       bool(e_d[j]), float(e_u[j]))
            hold = ~emit
            c_t, c_i, c_k = a_t[hold], a_i[hold], a_k[hold]
            c_d, c_u = a_d[hold], a_u[hold]



class DeviceScheduler:
    """Window scheduler for 10^5–10^6 simulated clients, its state on
    ``device``.

    State (``[n]`` tensors): each client's next-download-start time (f32)
    and cycle counter (i32).  :meth:`next_window` advances up to
    ``cycles_per_window`` communication cycles per client: a cycle
    advances iff its upload would complete inside the window, so cycles
    spanning the boundary are recomputed idempotently next window (all
    draws are pure hashes of (seed, client, cycle)).  The window's cohort
    is the first ``cohort_cap`` non-dropped completions by arrival time,
    ties to the lower client id (the reference's ``top_k``), with the cap
    rounded up to a power of two as the engine buckets.  Host traffic per
    window: the ``[cohort_cap]`` id and arrival vectors and four scalar
    counters, in one copy.

    Counters that would silently cap coverage are reported instead:
    ``overflow_arrivals`` (completions beyond ``cohort_cap``) and
    ``saturated_clients`` (clients that could have completed yet another
    cycle in-window when the ``cycles_per_window`` budget ran out — their
    backlog slides to the next window).
    """

    def __init__(self, model, *, window_len: float, cohort_cap: int = 256,
                 cycles_per_window: int = 8, window_log_cap: int = 1024,
                 device="cuda"):
        if window_len <= 0:
            raise ValueError("window_len must be > 0")
        self.device = resolve_device(device)
        n = int(model.n_clients)
        self.model = model
        self.n_clients = n
        self.window_len = float(window_len)
        self.cohort_cap = 1 << max(int(cohort_cap) - 1, 0).bit_length()
        self.cycles_per_window = int(cycles_per_window)
        self.window = 0
        self.stats = {"windows": 0, "arrivals": 0, "dropouts": 0,
                      "cohort_fill_sum": 0, "cohort_fill_max": 0,
                      "overflow_arrivals": 0, "saturated_clients": 0}
        self.window_log: List[dict] = []
        self._window_log_cap = int(window_log_cap)

        def on_device(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x)).to(self.device, dtype)

        self._seed = int(model.seed)
        j0, j1 = (float(model.jitter[0]), float(model.jitter[1]))
        # scalars formed as the reference forms them: j1 - j0 and
        # mean_down * up_factor in float64, then cast to float32
        self._j0 = _f32(j0)
        self._jw = _f32(j1 - j0)
        self._scale = _f32(model.scale)
        self._dropout = float(getattr(model, "dropout", 0.0))
        mult = getattr(model, "tier_mult", None)
        self._mult = on_device(mult if mult is not None else np.ones(n))
        # per-client delay coefficients, scale × mean in float32; without a
        # diurnal curve the tier multiplier folds in too, in the order the
        # reference's compiler folds its constant operands
        self._down = self._scale * on_device(model.mean_down)
        self._up = self._scale * on_device(model.mean_down * model.up_factor)
        self._diurnal = getattr(model, "diurnal", None)
        if self._diurnal is None:
            self._down = self._down * self._mult
            self._up = self._up * self._mult
        else:
            self._phase = on_device(model.phase)
            self._period = _f32(self._diurnal.period)
            self._floor = _f32(self._diurnal.floor)
            # 1 - floor in float32, as the reference's weak-typed scalar
            self._span = float(np.float32(1.0) - np.float32(self._floor))
        # the counter-free first round of every draw's hash, per client
        self._cw = client_word_torch(
            self._seed, torch.arange(n, dtype=torch.int64,
                                     device=self.device))
        self._t = torch.zeros(n, dtype=torch.float32, device=self.device)
        self._k = torch.zeros(n, dtype=torch.int32, device=self.device)

    @classmethod
    def from_spec(cls, spec, **kw) -> "DeviceScheduler":
        return cls(spec.build(), **kw)

    # -- one window, on the device ------------------------------------------

    def _u01(self, k: torch.Tensor, tag: int) -> torch.Tensor:
        return hash_u01_torch(self._seed, None, k, tag, client_word=self._cw)

    def _leg_end(self, coef: torch.Tensor, k: torch.Tensor, tag: int,
                 tt: torch.Tensor) -> torch.Tensor:
        """End of one leg of cycle ``k`` (int64) that starts at ``tt``:
        ``tt`` + coefficient × jitter (over availability with a diurnal
        curve), with the reference's multiply-adds fused."""
        u = self._u01(k, tag)
        jit = fma_f32(u, self._jw, self._j0)
        if self._diurnal is None:
            return fma_f32(jit, coef, tt)
        ph = _f32(_TWO_PI) * (tt / self._period + self._phase)
        avail = self._floor + self._span * 0.5 * (1.0 + torch.sin(ph))
        return fma_f32(coef * jit, self._mult / avail, tt)

    def _cycle_times(self, t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Upload-completion time of each client's cycle ``k`` (int64)
        started at ``t`` (the reference's ``cycle_times``)."""
        t_arr = self._leg_end(self._down, k, TAG_DOWN, t)
        return self._leg_end(self._up, k, TAG_UP, t_arr)

    def _step(self, w_end: float):
        t, k = self._t, self._k
        n = self.n_clients
        inf = float("inf")
        arr = torch.full((n,), inf, dtype=torch.float32, device=self.device)
        drops = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(self.cycles_per_window):
            k64 = k.to(torch.int64)
            t_up = self._cycle_times(t, k64)
            adv = t_up < w_end
            if self._dropout > 0.0:
                drop = self._u01(k64, TAG_DROP) < self._dropout
                arr = torch.where(adv & ~drop & (arr == inf), t_up, arr)
                drops = drops + (adv & drop).sum()
            else:
                arr = torch.where(adv & (arr == inf), t_up, arr)
            t = torch.where(adv, t_up, t)
            k = torch.where(adv, k + 1, k)
        # scan-budget saturation probe (pure; state unchanged)
        saturated = (self._cycle_times(t, k.to(torch.int64)) < w_end).sum()
        arrivals = (arr < inf).sum()
        # the first cap arrivals, ties to the lower id: a stable sort picks
        # what the reference's top_k of -arr picks, in its order
        times, idx = torch.sort(arr, stable=True)
        times, idx = times[:self.cohort_cap], idx[:self.cohort_cap]
        valid = torch.isfinite(times)
        counts = torch.stack([valid.sum(), arrivals, drops, saturated])
        self._t, self._k = t, k
        return idx, times, valid, counts

    def next_window(self) -> Tuple[np.ndarray, np.ndarray]:
        """Advance one window; -> (cohort client ids, arrival times),
        both ``[fill]`` numpy arrays in arrival order."""
        w_end = _f32(self.window_len * (self.window + 1))
        idx, times, valid, counts = self._step(w_end)
        # one copy to the host: [cap] ids and times, validity, 4 counters
        host = torch.cat([idx.to(torch.float64), times.to(torch.float64),
                          valid.to(torch.float64),
                          counts.to(torch.float64)]).cpu().numpy()
        cap = idx.shape[0]
        idx = host[:cap].astype(np.int32)
        ctimes = host[cap:2 * cap].astype(np.float32)
        valid = host[2 * cap:3 * cap].astype(bool)
        fill, arrivals, drops, saturated = (int(x) for x in host[3 * cap:])
        self.window += 1
        st = self.stats
        st["windows"] += 1
        st["arrivals"] += arrivals
        st["dropouts"] += drops
        st["cohort_fill_sum"] += fill
        st["cohort_fill_max"] = max(st["cohort_fill_max"], fill)
        st["overflow_arrivals"] += max(arrivals - fill, 0)
        st["saturated_clients"] += saturated
        if len(self.window_log) < self._window_log_cap:
            self.window_log.append({
                "window": self.window, "fill": fill,
                "arrivals": arrivals, "dropouts": drops,
                "overflow": max(arrivals - fill, 0),
                "saturated": saturated})
        return idx[valid], ctimes[valid]
