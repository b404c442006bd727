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
fire.  :class:`repro_torch.fl.scenario.ChurnModel` (device tiers, diurnal
availability, dropout, adversaries) overrides the ``_speed`` / ``drops_at``
/ ``corruption_factors`` hooks.

:func:`hash_u32_torch` / :func:`hash_u01_torch` are the torch twins the
device scheduler (:mod:`repro_torch.fl.scenario.sched`) draws with: the same
bits as the numpy hashes, on the CPU and on CUDA.  PyTorch's ``uint32`` has
no multiply or shift on every backend, so they run on ``int64`` tensors
holding values in [0, 2^32): a product wraps in 64 bits and its low 32 bits
are masked off before the next shift, which is exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# stream tags: independent hash sub-streams per random property
TAG_DOWN = 1      # per-cycle download jitter
TAG_UP = 2        # per-cycle upload jitter
TAG_MEAN = 3      # per-client mean download delay
TAG_FACTOR = 4    # per-client upload factor
TAG_DROP = 5      # per-cycle mid-round dropout coin
TAG_TIER = 6      # per-client device-class tier (ChurnModel)
TAG_PHASE = 7     # per-client diurnal phase (ChurnModel)
TAG_ADV = 8       # per-client adversary assignment (ChurnModel)

_MASK32 = 0xFFFFFFFF


def _seed_word(seed) -> int:
    return (int(seed) * 2654435761 + 0x632BE59B) & _MASK32


def _tag_word(tag) -> int:
    return (int(tag) * 0x9E3779B9 + 1) & _MASK32


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
    s = np.uint32(_seed_word(seed))
    tg = np.uint32(_tag_word(tag))
    h = _mix32((client * np.uint32(0x85EBCA77)).astype(np.uint32) ^ s)
    h = _mix32(h ^ (counter * np.uint32(0xC2B2AE3D)).astype(np.uint32))
    h = _mix32(h ^ tg)
    return h


def hash_u01(seed, client, counter, tag):
    """Uniform [0, 1) from the top 24 bits of :func:`hash_u32` (exact in
    float64)."""
    h = hash_u32(seed, client, counter, tag) >> np.uint32(8)
    return h.astype(np.float64) * (2.0 ** -24)


def _mix32_torch(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix32` on an int64 tensor of values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def client_word_torch(seed, client: torch.Tensor) -> torch.Tensor:
    """The counter-free first round of :func:`hash_u32_torch` for
    ``client`` (an integer tensor); a scheduler computes it once per
    client and passes it as ``client_word=``."""
    c = client.to(torch.int64) & _MASK32
    return _mix32_torch(((c * 0x85EBCA77) & _MASK32) ^ _seed_word(seed))


def hash_u32_torch(seed, client, counter, tag, *,
                   client_word: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """:func:`hash_u32` on integer tensors (broadcast), as int64 values in
    [0, 2^32): bit-equal to the numpy hash for ids and counters across the
    whole uint32 range."""
    h = client_word if client_word is not None \
        else client_word_torch(seed, client)
    k = torch.as_tensor(counter, device=h.device).to(torch.int64) & _MASK32
    h = _mix32_torch(h ^ ((k * 0xC2B2AE3D) & _MASK32))
    return _mix32_torch(h ^ _tag_word(tag))


def hash_u01_torch(seed, client, counter, tag, *,
                   client_word: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Uniform [0, 1) in float32 from the top 24 bits of
    :func:`hash_u32_torch`: the value of :func:`hash_u01`, exactly."""
    h = hash_u32_torch(seed, client, counter, tag,
                       client_word=client_word) >> 8
    return h.to(torch.float32) * (2.0 ** -24)


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
