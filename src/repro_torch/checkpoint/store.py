"""npz-based tree checkpoints, in the layout of
``src/repro/checkpoint/store.py``, so a file written by either package loads
in the other.

Trees are flattened to ``path/to/leaf``-keyed arrays (dict keys joined by
``/``, list and tuple indices spelled ``#i``); structure rebuilds from the
key paths.  Dataclasses (:class:`repro_torch.core.types.ServerState`) are
stored as their field dicts.  List rebuild keeps gaps: an absent ``#i``
comes back as ``None``, so the pruned personal-subset trees of
:mod:`repro_torch.core.subset` round-trip with their structure.

Leaves may be tensors (on any device) or numpy arrays; they are written from
the host.  bfloat16 leaves are written as their 16 bits (``uint16``) beside a
``__dt__:<key>`` marker naming the dtype, as the reference writes them.
numpy has no bfloat16 of its own, so :func:`load_pytree` returns such leaves
as CPU ``torch.bfloat16`` tensors and every other leaf as a numpy array.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np
import torch

DTYPE_KEY_PREFIX = "__dt__:"


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out.update(_flatten({f.name: getattr(tree, f.name)
                             for f in dataclasses.fields(tree)}, prefix))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.startswith("#") for k in keys):
            by_idx = {int(k[1:]): node[k] for k in keys}
            return [rebuild(by_idx[i]) if i in by_idx else None
                    for i in range(max(by_idx) + 1)]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def pack_dtypes(flat: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Leaves as host numpy arrays; bf16 (and any other non-npz-native
    dtype) as unsigned-int bit patterns plus a dtype marker."""
    out: Dict[str, np.ndarray] = {}
    for key, val in flat.items():
        if isinstance(val, torch.Tensor):
            t = val.detach().cpu()
            if t.dtype == torch.bfloat16:
                out[key] = t.view(torch.int16).numpy().view(np.uint16)
                out[DTYPE_KEY_PREFIX + key] = np.asarray("bfloat16")
                continue
            val = t.numpy()
        arr = np.asarray(val)
        if arr.dtype.kind == "V":
            out[key] = arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
            out[DTYPE_KEY_PREFIX + key] = np.asarray(arr.dtype.name)
        else:
            out[key] = arr
    return out


def unpack_dtypes(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`pack_dtypes`: bf16-marked leaves become CPU bf16
    tensors, markers are dropped."""
    markers = {k[len(DTYPE_KEY_PREFIX):]: str(flat[k]) for k in flat
               if k.startswith(DTYPE_KEY_PREFIX)}
    out: Dict[str, Any] = {k: v for k, v in flat.items()
                           if not k.startswith(DTYPE_KEY_PREFIX)}
    for key, name in markers.items():
        if name != "bfloat16":
            raise TypeError(f"checkpoint leaf {key!r} has dtype {name}, "
                            f"which the port does not load")
        bits = np.ascontiguousarray(out[key]).view(np.int16)
        out[key] = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return out


def save_pytree(path: str, tree, meta: Dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **pack_dtypes(_flatten(tree)))
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load_pytree(path: str):
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(unpack_dtypes(flat))


def load_meta(path: str) -> Dict | None:
    """The sidecar ``.meta.json`` written by :func:`save_pytree`, or None."""
    if path.endswith(".npz"):
        path = path[:-len(".npz")]
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)


def save_server_state(path: str, state, meta: Dict | None = None):
    save_pytree(path, state, meta)


def load_server_state(path: str):
    """A server-state checkpoint, re-typed as :class:`ServerState` (params
    as loaded: numpy arrays, bf16 leaves as CPU tensors; the counters as
    numpy scalars of the reference's dtypes)."""
    from repro_torch.core.types import ServerState
    tree = load_pytree(path)
    if isinstance(tree, dict) and set(tree) == {
            f.name for f in dataclasses.fields(ServerState)}:
        return ServerState(params=tree["params"],
                           t=np.int32(tree["t"]),
                           staleness_sum=np.float32(tree["staleness_sum"]),
                           staleness_max=np.int32(tree["staleness_max"]))
    return tree
