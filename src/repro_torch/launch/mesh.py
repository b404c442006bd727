"""Production mesh construction, as in ``src/repro/launch/mesh.py``.

Functions, so importing this module touches no process group.  Single pod:
(16, 16) = 256 ranks, axes ("data", "model"); two pods: (2, 16, 16) = 512,
axes ("pod", "data", "model"), the "pod" axis carrying only client-cohort
(data) parallelism.  One rank per device: the world of the process group
(:func:`repro_torch.sharding.ctx.init_distributed`) must have the mesh's
size.
"""
from __future__ import annotations

from repro_torch.sharding import ctx


def _make(shape, axes):
    import math
    n = ctx.world_size()
    if n != math.prod(shape):
        raise ValueError(f"mesh {shape} over axes {axes} needs "
                         f"{math.prod(shape)} ranks, the process group has "
                         f"{n}")
    return ctx.device_mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes)


def make_host_mesh():
    """Degenerate 1×1 ("data", "model") mesh over a one-rank group."""
    return _make((1, 1), ("data", "model"))
