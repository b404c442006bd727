"""Client communication-delay models (paper §5) on counter-based streams,
a numpy copy of ``src/repro/fl/delays.py`` that draws bit-identical delays.

Per client: a mean download delay, and an upload delay 4–6× larger on
average; each round's realized delay is the mean scaled by uniform jitter.
Local compute time is negligible relative to communication (paper §5
assumption).  ``scale`` inflates all delays.

Every random property here is a *pure function* ``hash01(seed, client,
counter, tag)`` of a counter-based 32-bit hash — there is no shared
sequential RNG stream, so client *i*'s delay sequence depends only on
(seed, i), never on ``n_clients`` or on the order other clients' events
fire.  The reference's ``ChurnModel`` (device tiers, diurnal availability,
dropout, adversaries) overrides the ``_speed`` / ``drops_at`` /
``corruption_factors`` hooks; it is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# stream tags: independent hash sub-streams per random property
TAG_DOWN = 1      # per-cycle download jitter
TAG_UP = 2        # per-cycle upload jitter
TAG_MEAN = 3      # per-client mean download delay
TAG_FACTOR = 4    # per-client upload factor


def _mix32(x):
    """32-bit finalizer (murmur3-style avalanche) on numpy uint32 arrays."""
    x = x ^ (x >> np.uint32(16))
    x = (x * np.uint32(0x7FEB352D)).astype(np.uint32)
    x = x ^ (x >> np.uint32(15))
    x = (x * np.uint32(0x846CA68B)).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    return x


def hash_u32(seed, client, counter, tag):
    """Counter-based uint32 hash of (seed, client, counter, tag).

    ``client``/``counter`` may be scalars or arrays (broadcast).
    """
    # >=1-d arrays: numpy integer *scalars* warn on uint32 wraparound,
    # arrays wrap silently (which is what a hash wants)
    client = np.atleast_1d(np.asarray(client)).astype(np.uint32)
    counter = np.atleast_1d(np.asarray(counter)).astype(np.uint32)
    s = np.uint32((int(seed) * 2654435761 + 0x632BE59B) & 0xFFFFFFFF)
    tg = np.uint32((int(tag) * 0x9E3779B9 + 1) & 0xFFFFFFFF)
    h = _mix32((client * np.uint32(0x85EBCA77)).astype(np.uint32) ^ s)
    h = _mix32(h ^ (counter * np.uint32(0xC2B2AE3D)).astype(np.uint32))
    h = _mix32(h ^ tg)
    return h


def hash_u01(seed, client, counter, tag):
    """Uniform [0, 1) from the top 24 bits of :func:`hash_u32` (exact in
    float64)."""
    h = hash_u32(seed, client, counter, tag) >> np.uint32(8)
    return h.astype(np.float64) * (2.0 ** -24)


@dataclasses.dataclass
class DelayModel:
    """Paper §5 delay statistics on independent per-client hash streams.

    Pure surface (the heap scheduler and the tests' oracles):

      * ``download_delay(i, k, t)`` / ``upload_delay(i, k, t)`` — client
        *i*'s cycle-*k* delay, starting at simulated time *t* (ignored by
        the base model).  ``i``/``k``/``t`` broadcast.
      * ``drops_at(i, k)`` — mid-round dropout coin (always False here).

    Stateful wrappers ``sample_download`` / ``sample_upload`` / ``drops``
    advance an internal per-client cycle counter and return scalars — the
    per-event heap consumes these, and because each client's cycles are
    strictly sequential the counter always equals the cycle index, making
    the heap and the vectorized paths draw identical values.
    """

    n_clients: int
    seed: int = 0
    down_range: Tuple[float, float] = (1.0, 3.0)
    up_factor_range: Tuple[float, float] = (4.0, 6.0)
    jitter: Tuple[float, float] = (0.5, 1.5)
    scale: float = 1.0

    def __post_init__(self):
        ids = np.arange(self.n_clients)
        lo, hi = self.down_range
        self.mean_down = lo + (hi - lo) * hash_u01(self.seed, ids, 0,
                                                   TAG_MEAN)
        lo, hi = self.up_factor_range
        self.up_factor = lo + (hi - lo) * hash_u01(self.seed, ids, 0,
                                                   TAG_FACTOR)
        # stateful per-client cycle counters (heap scheduler surface)
        self._kd = np.zeros(self.n_clients, np.int64)
        self._ku = np.zeros(self.n_clients, np.int64)
        self._kdrop = np.zeros(self.n_clients, np.int64)

    # -- pure, vectorizable surface ----------------------------------------

    def _jitter_u(self, i, k, tag):
        j0, j1 = self.jitter
        return j0 + (j1 - j0) * hash_u01(self.seed, i, k, tag)

    def _speed(self, i, t):
        """Delay multiplier at simulated time ``t`` (1 = nominal).
        ChurnModel overrides with tier × 1/availability."""
        return 1.0

    def download_delay(self, i, k, t=0.0):
        return (self.scale * self.mean_down[i]
                * self._jitter_u(i, k, TAG_DOWN) * self._speed(i, t))

    def upload_delay(self, i, k, t=0.0):
        return (self.scale * self.mean_down[i] * self.up_factor[i]
                * self._jitter_u(i, k, TAG_UP) * self._speed(i, t))

    def drops_at(self, i, k):
        """Mid-round dropout coin for client i's cycle k (vectorized)."""
        shape = np.broadcast(np.atleast_1d(i), np.atleast_1d(k)).shape
        return np.zeros(shape, bool)

    def corruption_factors(self, ids):
        """Per-client delta corruption factors (None = all honest)."""
        return None

    # -- stateful per-event surface ----------------------------------------

    def sample_download(self, i: int, t: float = 0.0) -> float:
        k = int(self._kd[i])
        self._kd[i] = k + 1
        return float(np.asarray(self.download_delay(i, k, t)).item(0))

    def sample_upload(self, i: int, t: float = 0.0) -> float:
        k = int(self._ku[i])
        self._ku[i] = k + 1
        return float(np.asarray(self.upload_delay(i, k, t)).item(0))

    def drops(self, i: int) -> bool:
        k = int(self._kdrop[i])
        self._kdrop[i] = k + 1
        return bool(self.drops_at(i, k).any())
