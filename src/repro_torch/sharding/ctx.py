"""Mesh context, tensor placement and the process group, as in
``src/repro/sharding/ctx.py``.

This module owns how every tensor of the port is *placed* across ranks.

  * **One process per device.**  The mesh is a
    ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of one
    process group: ``gloo`` on the CPU, ``nccl`` on the card, each rank's
    device ``cuda:{local rank}`` (or ``cpu``).  :func:`init_distributed` is
    the one function in the package that starts the process group; a mesh
    constructor refuses to run without one.
  * **The cohort/model mesh.**  :func:`cohort_mesh` is the 1-D
    ``("cohort",)`` layout; :func:`cohort_model_mesh` the 2-D ``("cohort",
    "model")`` one.  The "cohort" axis carries everything with a leading
    per-client or per-user row dim (delta banks, head banks, stacked client
    state): row ``i`` of a ``[bucket, ...]`` buffer lives on cohort slice
    ``i // (bucket // cohort_axis_size)`` (:func:`cohort_slice`).  The
    "model" axis shards *storage*: params at rest, ring snapshots and the
    model dims of every bank row, placed by ``rules.py`` specs.
  * **Storage is DTensor, compute is plain.**  ``torch.distributed.tensor``
    ``DTensor`` with ``Shard``/``Replicate`` placements stands where the
    reference has ``NamedSharding``, for storage only.  Compute runs on
    plain local tensors, as the reference's full-Manual ``shard_map`` does:
    the engine gathers model-sharded params before a cohort call
    (:func:`gather`), maps its own rows, and places the delta stack for
    storage after (:func:`place`).  A model-sharded gradient would
    reassociate reductions with the model-axis size and break bit-parity
    across mesh layouts; the cohort mean is one ``all_reduce`` per leaf over
    the "cohort" group only, since a reduction crossing "model" would
    multiply by the model-axis size.  DTensors never enter ``torch.func``.
  * **Every rank runs the same program.**  Row fetches (:func:`take_row`) and
    gathers are collectives, so every rank calls them in the same order;
    the numpy timelines, admission orders and batches are the same on every
    rank by construction (nothing is seeded per rank).

Meshes are memoized per (ranks, axis names, shape, device type):
:func:`reset_mesh_cache` is the one invalidation point.  :func:`use_mesh`
installs a mesh thread-locally and :func:`active_mesh` reads it back;
engines and the serving stack consume it when no explicit ``mesh=`` is
passed.  :func:`activation_sharding` / :func:`shard_activation` keep the
reference's names and are the identity on the port's plain tensors (the
reference installs rules only in its TPU dry run).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_state = threading.local()

# (ranks, axis names, axis sizes, device type) -> DeviceMesh.  One mesh
# object per layout, as in the reference: every mesh built makes process
# groups, so a fresh mesh per engine call would leak groups.
_MESH_CACHE: Dict[Tuple, object] = {}


# -- the process group --------------------------------------------------------

def local_rank() -> int:
    """This process's index among the ranks of its host: ``LOCAL_RANK`` when
    a launcher set it, else the global rank modulo the host's card count
    (0 without cards)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return rank % n if n else 0


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:{local rank}`` for ``"cuda"``, the
    CPU for ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def init_distributed(*, coordinator: Optional[str] = None,
                     num_processes: int = 1, process_id: int = 0,
                     init_method: Optional[str] = None, device="cuda",
                     timeout_s: float = 300.0) -> torch.device:
    """Start the process group this process is rank ``process_id`` of, and
    return the rank's device.

    ``coordinator`` is ``HOST:PORT`` (``init_method`` ``tcp://HOST:PORT``);
    tests pass a ``file://`` ``init_method`` instead.  The backend is
    ``nccl`` for ``device="cuda"`` (the rank's card is made current first)
    and ``gloo`` for the CPU.  A rank that waits longer than ``timeout_s``
    for its peers raises instead of hanging.  Calling it again in a process
    whose group is up returns the device and starts nothing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch: device={str(device)!r} needs a CUDA GPU and "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"on the CPU")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} must lie in [0, "
                         f"num_processes={num_processes})")
    if init_method is None:
        if coordinator is None:
            raise ValueError("need coordinator='HOST:PORT' or init_method")
        host, _, port = coordinator.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator must be HOST:PORT, got "
                             f"{coordinator!r}")
        init_method = f"tcp://{coordinator}"
    if dist.is_initialized():
        return rank_device(dev)
    if dev.type == "cuda":
        # the rank's card is current before NCCL starts
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return rank_device(dev)


def world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start one with "
            "repro_torch.sharding.ctx.init_distributed(...) (one process "
            "per device) before building a mesh")
    return dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


# -- memoized mesh construction -----------------------------------------------

def reset_mesh_cache() -> None:
    """Drop every memoized mesh (the mesh context owns invalidation: call it
    when the process group is torn down and started again)."""
    _MESH_CACHE.clear()


def device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    key = (tuple(range(world_size())), names, shape, _device_type())
    if key not in _MESH_CACHE:
        _MESH_CACHE[key] = init_device_mesh(_device_type(), shape,
                                            mesh_dim_names=names)
    return _MESH_CACHE[key]


def cohort_mesh():
    """The 1-D ``("cohort",)`` mesh over every rank (memoized: repeated
    engine and batcher calls share one mesh object).  Row ``i`` of a
    ``[bucket, ...]`` cohort buffer lives on cohort slice ``i // (bucket //
    n)``, which the serving batcher's user keying relies on."""
    return cohort_model_mesh(model_axis=None)


def cohort_model_mesh(model_axis: Optional[int] = None):
    """The ``("cohort", "model")`` mesh: ``(n // m, m)`` over the world's
    ``n`` ranks.  ``model_axis=None`` is the 1-D ``("cohort",)`` mesh (the
    same cache entry as :func:`cohort_mesh`); ``model_axis=1`` the 2-D mesh
    with a degenerate model axis, a distinct layout with the same cohort
    split."""
    n = world_size()
    if model_axis is None:
        return device_mesh((n,), ("cohort",))
    m = int(model_axis)
    if m < 1 or n % m:
        raise ValueError(f"model_axis={m} must divide the device count "
                         f"({n})")
    return device_mesh((n // m, m), ("cohort", "model"))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or of any object with
    ``axis_names`` and ``shape`` (the rules' process-free meshes)."""
    names = getattr(mesh, "mesh_dim_names", None) \
        or getattr(mesh, "axis_names")
    return dict(zip(names, tuple(mesh.shape)))


def cohort_axis_size(mesh) -> int:
    """Number of cohort slices of a mesh; a mesh without a "cohort" axis
    has one."""
    return int(mesh_axis_sizes(mesh).get("cohort", 1))


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the ambient cohort/model mesh."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def active_mesh():
    """The mesh installed by :func:`use_mesh`, or None."""
    return getattr(_state, "mesh", None)


# -- this rank's block of a cohort bucket ---------------------------------------

@dataclasses.dataclass(frozen=True)
class CohortSlice:
    """This rank's block ``[start, stop)`` of a bucket split over the mesh
    axes ``axes``: slice ``index`` of ``count``, the slices numbered
    row-major over those axes.  ``groups`` are the process groups of those
    axes through this rank; a sum over the slices is one ``all_reduce`` per
    group (:meth:`all_reduce`)."""
    index: int
    count: int
    start: int
    stop: int
    groups: Tuple

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the slices (over these axes only)."""
        if self.count > 1:
            for g in self.groups:
                dist.all_reduce(t, group=g)
        return t


def cohort_slice(mesh, bucket: int,
                 axes: Sequence[str] = ("cohort",)) -> CohortSlice:
    """This rank's block of a ``bucket``-row cohort buffer split over
    ``axes`` (row ``i`` on slice ``i // (bucket // count)``) and the
    process groups of those axes: the one helper the engine and
    ``launch/steps.py`` share, as the reference's ``shard_map_compat``."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, count, groups = 0, 1, []
    for ax in axes:
        d = names.index(ax)
        index = index * mesh.size(d) + coord[d]
        count *= mesh.size(d)
        if mesh.size(d) > 1:
            groups.append(mesh.get_group(d))
    if bucket % count:
        raise ValueError(f"bucket {bucket} does not split over {count} "
                         f"slices of axes {tuple(axes)}")
    per = bucket // count
    return CohortSlice(index, count, index * per, (index + 1) * per,
                       tuple(groups))


# -- placement of storage -------------------------------------------------------

def is_sharded(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spans_devices(tree) -> bool:
    """True when a leaf of ``tree`` is a DTensor over a mesh of more than
    one rank (a stack that spans devices)."""
    from repro_torch.tree import tree_leaves
    return any(is_sharded(x) and x.device_mesh.size() > 1
               for x in tree_leaves(tree))


def _global_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of ``full`` under ``placements`` (torch.chunk
    splits, as DTensor's ``Shard``: a rank past the last chunk holds an
    empty piece).  No communication."""
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements):
        if p.is_shard():
            parts = torch.chunk(out, mesh.size(i), dim=p.dim)
            out = parts[coord[i]] if coord[i] < len(parts) \
                else out.narrow(p.dim, 0, 0)
    return out.contiguous()


def place_local(local: torch.Tensor, mesh, placements, shape):
    """Wrap this rank's piece ``local`` of a global ``shape`` tensor as a
    DTensor (no communication, no check)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=_global_stride(shape))


def place_full(full: torch.Tensor, mesh, placements):
    """``full`` (the same on every rank) stored under ``placements``."""
    return place_local(local_shard(full, mesh, placements), mesh,
                       placements, full.shape)


def gather(tree):
    """Plain full tensors of a tree: DTensor leaves all-gathered
    (``full_tensor()``), plain leaves as they are."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.full_tensor() if is_sharded(x) else x, tree)


def local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if is_sharded(x) else x


def like(x_local: torch.Tensor, ref):
    """``x_local`` placed as ``ref`` is (plain when ``ref`` is plain)."""
    if not is_sharded(ref):
        return x_local
    return place_local(x_local, ref.device_mesh, ref.placements, ref.shape)


def _cohort_dim(mesh) -> int:
    return tuple(mesh.mesh_dim_names).index("cohort")


def row_placements(placements, cohort_dim: int):
    """Placements of one row of a stack placed as ``placements``: the
    cohort split dropped, every other shard one dim lower."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for i, p in enumerate(placements):
        if i == cohort_dim or not p.is_shard():
            out.append(Replicate())
        else:
            out.append(Shard(p.dim - 1))
    return out


def stack_placements(mesh, row: Optional[Sequence] = None):
    """Placements of a ``[bucket, ...]`` stack on ``mesh``: rows split over
    "cohort", each row's dims placed as ``row`` (a leaf's placements, e.g.
    its param's; replicated when None), one dim higher."""
    from torch.distributed.tensor import Replicate, Shard
    cd = _cohort_dim(mesh)
    out = []
    for i in range(mesh.ndim):
        if i == cd:
            out.append(Shard(0))
        elif row is not None and row[i].is_shard():
            out.append(Shard(row[i].dim + 1))
        else:
            out.append(Replicate())
    return out


def place_rows(local_rows: torch.Tensor, mesh, bucket: int,
               row: Optional[Sequence] = None):
    """Store this rank's cohort block ``local_rows`` (``[per, *shape]``,
    full row width) of a ``bucket``-row stack: split over "cohort" and each
    row's dims as ``row``.  A pure placement: the model split is a slice of
    rows this rank already holds."""
    from torch.distributed.tensor import Replicate
    pl = stack_placements(mesh, row)
    cut = list(pl)
    cut[_cohort_dim(mesh)] = Replicate()
    return place_local(local_shard(local_rows, mesh, cut), mesh, pl,
                       (bucket,) + tuple(local_rows.shape[1:]))


def row_block(x) -> Tuple[int, int]:
    """``[start, stop)`` of the rows this rank holds of a stack (all of
    them for a plain tensor)."""
    if not is_sharded(x):
        return 0, x.shape[0]
    mesh = x.device_mesh
    cd = _cohort_dim(mesh)
    n = mesh.size(cd)
    per = x.shape[0] // n
    c = mesh.get_coordinate()[cd]
    return c * per, (c + 1) * per


def rowwise(x, vec: torch.Tensor, fn):
    """``fn(rows, vec_rows)`` over the rows of a stack and the matching
    entries of a ``[capacity]`` vector; a sharded stack maps only the rows
    this rank holds and keeps its placement."""
    if not is_sharded(x):
        return fn(x, vec)
    start, stop = row_block(x)
    return like(fn(x.to_local(), vec[start:stop]), x)


def cohort_rows(x) -> torch.Tensor:
    """This rank's block of a stack's rows at full row width, plain: the
    row dims gathered over the other mesh axes, the cohort split kept (the
    whole stack for a plain tensor)."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    cd = _cohort_dim(mesh)
    pl = [Shard(0) if i == cd else Replicate() for i in range(mesh.ndim)]
    if list(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    return x.to_local()


def place_like_rows(local_rows: torch.Tensor, stack):
    """``local_rows`` (this rank's block at full row width, as
    :func:`cohort_rows` gives) stored as ``stack``'s rows are (its
    placements; same capacity); plain when ``stack`` is."""
    if not is_sharded(stack):
        return local_rows
    mesh = stack.device_mesh
    row = row_placements(stack.placements, _cohort_dim(mesh)) \
        if stack.dim() == local_rows.dim() else None
    return place_rows(local_rows, mesh, stack.shape[0], row)


def take_row(x, i: int):
    """Row ``i`` of a stack.  A sharded stack's row is broadcast from the
    cohort slice that owns it to the others (one broadcast over this rank's
    "cohort" group) and comes back as a DTensor placed as the row's dims
    were; a plain stack's row is a view."""
    if not is_sharded(x):
        return x[i]
    mesh = x.device_mesh
    cd = _cohort_dim(mesh)
    n = mesh.size(cd)
    per = x.shape[0] // n
    owner, r = divmod(int(i), per)
    coord = list(mesh.get_coordinate())
    loc = x.to_local()
    buf = loc[r].clone() if coord[cd] == owner else torch.empty_like(loc[0])
    if n > 1:
        coord[cd] = owner
        src = int(mesh.mesh[tuple(coord)])
        dist.broadcast(buf, src=src, group=mesh.get_group(cd))
    return place_local(buf, mesh, row_placements(x.placements, cd),
                       x.shape[1:])


def rows_like(stack, w) -> torch.Tensor:
    """All rows of ``stack`` as one plain ``[M, *w_local.shape]`` tensor cut
    to ``w``'s local piece (``w`` whole when plain).  When the stack's row
    dims are placed as ``w``'s, only the cohort split moves; otherwise the
    stack is gathered whole and cut."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_sharded(w):
        return stack.full_tensor() if is_sharded(stack) else stack
    mesh = w.device_mesh
    rows = [Shard(p.dim + 1) if p.is_shard() else p for p in w.placements]
    if is_sharded(stack) and stack.device_mesh is mesh:
        pl = list(stack.placements)
        pl[_cohort_dim(mesh)] = Replicate()
        if pl == rows:
            return stack.redistribute(mesh, pl).to_local()
    return piece(stack, mesh, rows)


def piece(x, mesh, placements) -> torch.Tensor:
    """The plain local piece of ``x`` (plain or placed) under ``placements``
    on ``mesh``: a placed ``x`` already laid out so gives its local tensor,
    anything else is gathered whole and cut."""
    if is_sharded(x):
        if x.device_mesh is mesh and list(x.placements) == list(placements):
            return x.to_local()
        x = x.full_tensor()
    return local_shard(x, mesh, placements)


def piece_like(x, ref) -> torch.Tensor:
    """The plain piece of ``x`` (a tensor of ``ref``'s global shape) that
    matches ``ref``'s local piece; ``x`` whole when ``ref`` is plain."""
    if not is_sharded(ref):
        return x.full_tensor() if is_sharded(x) else x
    return piece(x, ref.device_mesh, ref.placements)


def row_piece(p, stack) -> torch.Tensor:
    """The plain piece of ``p`` (a row's worth: a params leaf, plain or
    placed) that matches this rank's piece of each row of ``stack``."""
    if not is_sharded(stack):
        return p.full_tensor() if is_sharded(p) else p
    mesh = stack.device_mesh
    return piece(p, mesh, row_placements(stack.placements,
                                         _cohort_dim(mesh)))


# -- activation sharding --------------------------------------------------------

def _rules():
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def activation_sharding(rules: Dict):
    """Install a logical activation-name -> spec mapping (the reference's
    TPU dry run does; the port's models run on plain tensors)."""
    prev = _rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def shard_activation(x, name: str):
    """The identity: the port's activations are plain local tensors (compute
    is model-replicated, see the module docstring), so no installed rule
    constrains them."""
    del name
    return x


