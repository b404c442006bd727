"""The serving batcher's cohort-slice-major layout
(``MicroBatcher._layout``, ``n_shards``) against the JAX package's, in the
pytest process (pure logic on tickets; no process group): for random
queues of repeated and fresh users over 1, 2, 4 and 8 slices, the same
batch order, the same (ticket, row) placement in submit order and the
same ``shard_padding``; with one slice, the submit order."""
import numpy as np
import pytest

from repro.serving.batcher import MicroBatcher as JBatcher
from repro.serving.batcher import Ticket as JTicket
from repro_torch.serving.batcher import MicroBatcher, Ticket


def _queue(seed, n):
    rng = np.random.RandomState(seed)
    users = [f"user{int(u):03d}" for u in rng.randint(0, 12, n)]
    return [(u, {"i": i}) for i, u in enumerate(users)]


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("seed,n", [(0, 1), (1, 5), (2, 13), (3, 30)])
def test_layout_matches_reference(n_shards, seed, n):
    queue = _queue(seed, n)
    tb = MicroBatcher({"C": None}, n_shards=n_shards)
    jb = JBatcher({"C": None}, n_shards=n_shards)
    t_list, t_placed = tb._layout([(Ticket(user=u, mode="C", stamp=0), b)
                                   for u, b in queue])
    j_list, j_placed = jb._layout([(JTicket(user=u, mode="C", stamp=0), b)
                                   for u, b in queue])
    assert [b["i"] for b in t_list] == [b["i"] for b in j_list]
    assert [(t.user, r) for t, r in t_placed] == \
        [(t.user, r) for t, r in j_placed]
    assert tb.stats["shard_padding"] == jb.stats["shard_padding"]
    if n_shards == 1:
        assert [r for _, r in t_placed] == list(range(n))
    else:
        # a user keeps its slice: row // per-slice slots is crc32 % n
        per = len(t_list) // n_shards
        for t, r in t_placed:
            assert r // per == tb._shard(t.user)
