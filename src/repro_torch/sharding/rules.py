"""Per-architecture partition specs, as in ``src/repro/sharding/rules.py``.

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod, or the FL path's ``("cohort", "model")``.  Tensor parallelism on
``model`` (attention heads, FFN hidden, MoE experts, vocab), client-cohort
data parallelism on ``data``/``pod``, optional FSDP over the data axes for
the ≥70B archs.

Rules are name-based on the flattened parameter paths and right-aligned
against the trailing dims, so stacked (scan-over-layers) leaves pick up
leading ``None``s.  Every sharded dim is checked against the mesh; an
indivisible dim falls back to replication.

The port keeps the reference's spec as a tuple of its own,
:class:`PartitionSpec` (``P``), whose entries are ``None``, an axis name or
a tuple of axis names.  :func:`spec_placements` turns one into DTensor
placements for a ``DeviceMesh``, and :class:`NamedSharding` pairs a spec
with its mesh.  Everything here is pure logic on axis names and sizes: a
mesh is a ``DeviceMesh`` or any object with ``axis_names`` and ``shape``
(:class:`MeshShape`), so no process group is needed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.ctx import mesh_axis_sizes
from repro_torch.tree import tree_unflatten

# archs whose weights additionally FSDP-shard over the data axes
FSDP_ARCHS = {"deepseek-v3-671b", "qwen1.5-110b", "internvl2-76b"}

# trailing-dim rules
_COL = ("wq", "wk", "wv", "wg", "wu", "w1", "w_uq", "w_uk", "w_uv",
        "in_proj", "vis_proj", "proj")          # (d_in, big) -> shard dim -1
_ROW = ("wo", "wd", "w2", "out_proj")           # (big, d_out) -> shard dim -2
_BIAS = ("bq", "bk", "bv")
_REPL = ("w_dq", "w_dkv", "w_krope", "router", "conv_b", "a_log", "dt_bias",
         "d_skip", "gate_norm", "ln", "ln1", "ln2", "ln_in", "ln_mlp",
         "ln_x", "ln1_post", "ln2_post", "final_norm", "enc_norm", "norm")


class PartitionSpec(tuple):
    """A partition spec: one entry per tensor dim, ``None``, an axis name
    or a tuple of axis names (a 1-tuple reads as its bare name, as
    ``jax.sharding.PartitionSpec`` reads it)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without ranks."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def spec_placements(spec, mesh):
    """DTensor placements of ``spec`` on ``mesh``: mesh dim ``i`` is
    ``Shard(d)`` where tensor dim ``d``'s entry names that axis, else
    ``Replicate()``.  A tuple of axes, e.g. ``("pod", "data")``, shards one
    dim over each of those mesh dims in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_axis_sizes(mesh))
    by_axis: Dict[str, int] = {}
    for d, part in enumerate(spec):
        for ax in (part if isinstance(part, tuple) else (part,)):
            if ax is None:
                continue
            if ax not in names:
                raise ValueError(f"spec {spec!r} names axis {ax!r}, not an "
                                 f"axis of the mesh {names}")
            by_axis[ax] = d
    return [Shard(by_axis[n]) if n in by_axis else Replicate()
            for n in names]


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self):
        return spec_placements(self.spec, self.mesh)


def _fits(dim_size: int, axes, sizes) -> bool:
    if axes is None:
        return True
    names = axes if isinstance(axes, tuple) else (axes,)
    return dim_size % math.prod(sizes[a] for a in names) == 0


def _guard(spec_parts, shape, sizes) -> P:
    """Replace indivisible entries with None; a 1-tuple reads as its bare
    axis name."""
    out = []
    for dim, axes in zip(shape, spec_parts):
        if axes is None or not _fits(dim, axes, sizes):
            out.append(None)
            continue
        if isinstance(axes, tuple) and len(axes) == 1:
            axes = axes[0]
        out.append(axes)
    return P(*out)


def data_axes(mesh):
    return ("pod", "data") if "pod" in mesh_axis_sizes(mesh) else ("data",)


def param_spec(cfg: ArchConfig, path: str, shape: Tuple[int, ...], mesh, *,
               expert_both_axes: bool = False,
               fsdp: Optional[bool] = None) -> P:
    sizes = mesh_axis_sizes(mesh)
    if fsdp is None:
        fsdp = cfg.arch_id in FSDP_ARCHS
    d_ax = data_axes(mesh)
    nd = len(shape)
    name = path.rsplit("/", 1)[-1]
    is_moe_expert = "/moe/" in path and name in ("wg", "wu", "wd")

    def right(parts):
        full = [None] * (nd - len(parts)) + list(parts)
        return _guard(full, shape, sizes)

    if is_moe_expert:
        # (..., E, d, f): experts on model (expert parallel); expert_both_axes
        # spreads them over the whole mesh (the serving layout)
        e_ax = tuple(d_ax) + ("model",) if expert_both_axes else "model"
        f2 = fsdp and not expert_both_axes
        if name in ("wg", "wu"):
            return right([e_ax, d_ax if f2 else None, None])
        return right([e_ax, None, d_ax if f2 else None])
    if path.endswith("embed/tok"):
        return right(["model", d_ax if fsdp else None])      # vocab-sharded
    if path.endswith("embed/unembed"):
        return right([d_ax if fsdp else None, "model"])
    if name == "conv_w":
        return right([None, "model"])
    if name in _BIAS:
        return right(["model"])
    if name in _REPL or nd <= 1:
        return P(*([None] * nd))
    if name in _COL:
        return right([d_ax if fsdp else None, "model"])
    if name in _ROW:
        return right(["model", d_ax if fsdp else None])
    return P(*([None] * nd))


def paths_and_leaves(tree):
    """``[(path, leaf)]`` in ``tree_leaves`` order, paths spelled as the
    reference's (``a/b/#0/c``)."""
    out = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}#{i}/")
        else:
            out.append((prefix[:-1], node))

    walk(tree, "")
    return out


def param_shardings(cfg: ArchConfig, params_shape, mesh,
                    model_parallel: bool = True, mode: str = "default"):
    """A :class:`NamedSharding` tree matching a params tree (real or meta
    tensors).  ``model_parallel=False`` replicates every leaf;
    ``mode="ep"`` is full-mesh expert parallelism without FSDP (the serving
    layout)."""
    flat = paths_and_leaves(params_shape)
    if not model_parallel:
        specs = [P(*([None] * len(leaf.shape))) for _, leaf in flat]
    elif mode == "ep":
        specs = [param_spec(cfg, path, tuple(leaf.shape), mesh,
                            expert_both_axes=True, fsdp=False)
                 for path, leaf in flat]
    else:
        specs = [param_spec(cfg, path, tuple(leaf.shape), mesh)
                 for path, leaf in flat]
    return tree_unflatten(params_shape,
                          [NamedSharding(mesh, s) for s in specs])


def batch_shardings(batch_shape, mesh, axes=None):
    """tokens/labels (B, S) etc.: the batch dim over (pod, data), or over an
    explicit axis tuple."""
    sizes = mesh_axis_sizes(mesh)
    d_ax = tuple(axes) if axes is not None else data_axes(mesh)
    flat = paths_and_leaves(batch_shape)
    return tree_unflatten(batch_shape, [
        NamedSharding(mesh, _guard([d_ax] + [None] * (len(leaf.shape) - 1),
                                   tuple(leaf.shape), sizes))
        for _, leaf in flat])


def cache_shardings(cfg: ArchConfig, cache_shape, mesh,
                    seq_on_model: bool = True):
    """KV/SSM caches: batch on data; heads on model when divisible, else
    the sequence dim on model (``seq_on_model=False`` turns that fallback
    off)."""
    del cfg
    sizes = mesh_axis_sizes(mesh)
    d_ax = data_axes(mesh)
    m = sizes["model"]
    out = []
    for path, leaf in paths_and_leaves(cache_shape):
        shape = tuple(leaf.shape)
        nd = len(shape)
        name = path.rsplit("/", 1)[-1]
        parts = [None] * nd
        if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
            # (L,B,T,Hkv,hd) or (B,T,Hkv,hd)
            b_i, t_i, h_i = nd - 4, nd - 3, nd - 2
            parts[b_i] = d_ax
            if shape[h_i] % m == 0:
                parts[h_i] = "model"
            elif seq_on_model and shape[t_i] % m == 0:
                parts[t_i] = "model"
        elif name in ("ckv", "krope"):
            # (L,B,T,r)
            parts[nd - 3] = d_ax
            if seq_on_model and shape[nd - 2] % m == 0:
                parts[nd - 2] = "model"
        elif name == "state":
            # (L,B,H,P,N)
            parts[nd - 4] = d_ax
            if shape[nd - 3] % m == 0:
                parts[nd - 3] = "model"
        elif name == "conv":
            # (L,B,W-1,conv_dim)
            parts[nd - 3] = d_ax
            if shape[nd - 1] % m == 0:
                parts[nd - 1] = "model"
        out.append(NamedSharding(mesh, _guard(parts, shape, sizes)))
    return tree_unflatten(cache_shape, out)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def strip_axes(rules_dict: Dict[str, P], axes) -> Dict[str, P]:
    """Remove the given mesh axes from every rule (None them out)."""
    axes = set(axes)

    def strip(spec: P) -> P:
        out = []
        for part in spec:
            if part is None:
                out.append(None)
            elif isinstance(part, tuple):
                kept = tuple(a for a in part if a not in axes)
                out.append(kept if kept else None)
            else:
                out.append(None if part in axes else part)
        return P(*out)

    return {k: strip(v) for k, v in rules_dict.items()}


def default_activation_rules(mesh) -> Dict[str, P]:
    """Logical activation name -> spec (see :mod:`repro_torch.sharding.ctx`)."""
    d_ax = data_axes(mesh)
    return {
        "residual": P(d_ax, None, None),
        "ffn": P(d_ax, None, "model"),
        "attn_out": P(d_ax, None, "model"),
        "ssm_out": P(d_ax, None, "model"),
        "moe_dispatch": P(d_ax, None, "model", None),
        "moe_expert_in": P("model", d_ax, None, None),
    }
