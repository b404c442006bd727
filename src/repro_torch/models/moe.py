"""Mixture-of-Experts layer, as in ``src/repro/models/moe.py``: a top-k
router, grouped capacity dispatch (one group per sequence, capacity per
(group, expert)), optional shared experts (DeepSeek-V3) and the router's
load-balance aux loss.

The reference dispatches through GShard one-hot einsums: its ``dispatch``
and ``combine`` tensors are (G, S, E, C) with C = ceil(S·K/E·capacity), so
they hold G·S²·K·capacity elements, quadratic in the sequence (granite-moe:
1.34e9 at (8, 4096), 1.07e10 at (1, 32768), more than one card holds).  The
port computes the same function by index:

  * the router's top-k by a stable descending sort of the gates, so equal
    gates (common among bf16 logits) come in expert order, as
    ``lax.top_k`` orders them: the order decides the experts chosen, the
    queue positions and the top-1 load of the aux loss;
  * each (token, slot) pair's queue position in its expert, the count of
    earlier pairs of that expert in the token-major (s, k) order, as its
    rank in a stable sort of the pairs by expert (integers throughout; a
    cumulative count over an (S·K, E) one-hot, as the reference forms it,
    scans the long axis one column at a time on the card: 12 ms a layer on
    an H100 at granite's (8, 4096)); a pair at position C or later is
    dropped, as GShard drops it;
  * the kept tokens copied into an (E, G·C, d) buffer (the reference's
    one-hot einsum is an exact copy too), the experts run as batched matrix
    products over E, and each pair gathers its expert's output back,
    weighted by its gate rounded to the activation dtype, as
    ``combine.astype(dt)`` rounds it.  A dropped pair's weight is 0 and an
    empty slot holds a copy of token 0, whose output no pair reads: both
    add exactly zero, to the output and to every gradient.

Every shape is static (C from S) and every index op out of place, so
``torch.func.vmap(grad(...))`` over a cohort runs the layer with each user
one group.  The reference computes the layer outside any Pallas kernel, and
so does the port: it has no kernel of its own.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import dense_init


def init_moe(generator: torch.Generator, cfg: ArchConfig):
    """Params on the CPU, drawn from ``generator``: the router, the stacked
    experts (E, d, f) / (E, f, d) and, with shared experts, ``shared``."""
    mo: MoEConfig = cfg.moe
    d = cfg.d_model
    p = {"router": dense_init(generator, (d, mo.n_experts), scale=0.02),
         "wg": dense_init(generator, (mo.n_experts, d, mo.expert_d_ff)),
         "wu": dense_init(generator, (mo.n_experts, d, mo.expert_d_ff)),
         "wd": dense_init(generator, (mo.n_experts, mo.expert_d_ff, d))}
    if mo.n_shared_experts:
        f = mo.shared_d_ff * mo.n_shared_experts
        p["shared"] = {"wg": dense_init(generator, (d, f)),
                       "wu": dense_init(generator, (d, f)),
                       "wd": dense_init(generator, (f, d))}
    return p


def expert_capacity(tokens_per_group: int, mo: MoEConfig) -> int:
    c = math.ceil(tokens_per_group * mo.top_k / mo.n_experts
                  * mo.capacity_factor)
    return max(int(c), mo.top_k)


def route(cfg: ArchConfig, p, x):
    """The router of ``x`` (G, S, d): gates (G, S, E) in f32, the top-k
    weights (normalized) and experts (G, S, K), each pair's queue position
    in its expert (G, S, K) and the capacity C."""
    mo: MoEConfig = cfg.moe
    G, S, _ = x.shape
    E, K = mo.n_experts, mo.top_k
    logits = (x @ p["router"].to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :K], top_i[..., :K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # queue position of each (token, slot) within its expert, earlier
    # tokens, then lower slots, first: its rank in its expert's run of a
    # stable sort of the pairs by expert, which keeps the token-major order
    # inside each run
    flat = top_i.reshape(G, S * K)
    by_expert, order = torch.sort(flat, dim=-1, stable=True)
    counts = torch.zeros(G, E, dtype=flat.dtype, device=x.device) \
        .scatter_add(1, flat, torch.ones_like(flat))
    first = torch.cumsum(counts, dim=-1) - counts            # run starts
    rank = torch.arange(S * K, device=x.device) - first.gather(1, by_expert)
    pos = torch.zeros_like(flat).scatter(1, order, rank).reshape(G, S, K)
    return gates, top_w, top_i, pos, expert_capacity(S, mo)


def dropped_pairs(cfg: ArchConfig, p, x) -> torch.Tensor:
    """The number of (token, slot) pairs of ``x`` (G, S, d) that capacity
    drops in ``moe_forward``, as a 0-d tensor."""
    *_, pos, C = route(cfg, p, x)
    return (pos >= C).sum()


def moe_forward(cfg: ArchConfig, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (G, S, d) -> (out (G, S, d), aux loss).  Groups are batch rows;
    pairs over capacity are dropped (capacity_factor 1.25 by default)."""
    mo: MoEConfig = cfg.moe
    dt = x.dtype
    G, S, d = x.shape
    E, K = mo.n_experts, mo.top_k
    gates, top_w, top_i, pos, C = route(cfg, p, x)
    keep = pos < C

    # --- dispatch: slot (e, g, c) of the (E·G·C, d) buffer ---------------
    dev = x.device
    n_slots = E * G * C
    g_idx = torch.arange(G, device=dev)[:, None, None]
    slot = top_i * (G * C) + g_idx * C + pos
    token = (g_idx * S + torch.arange(S, device=dev)[None, :, None]
             ).expand(G, S, K)
    # the token each slot holds; dropped pairs write past the end, and an
    # empty slot holds token 0
    src = torch.zeros(n_slots + 1, dtype=torch.long, device=dev).scatter(
        0, torch.where(keep, slot, n_slots).reshape(-1),
        token.reshape(-1))[:n_slots]
    xin = x.reshape(G * S, d).index_select(0, src).reshape(E, G * C, d)

    # --- the experts: batched matrix products over E --------------------
    h = torch.nn.functional.silu(xin @ p["wg"].to(dt)) \
        * (xin @ p["wu"].to(dt))
    out_e = h @ p["wd"].to(dt)                              # (E, G·C, d)

    # --- combine: each kept pair's expert output times its gate ---------
    back = out_e.reshape(n_slots, d).index_select(
        0, torch.where(keep, slot, 0).reshape(-1)).reshape(G, S, K, d)
    w = torch.where(keep, top_w, 0.0).to(dt)
    out = (w[..., None, :] @ back)[..., 0, :]

    # --- shared experts ------------------------------------------------
    if "shared" in p:
        sh = p["shared"]
        hs = torch.nn.functional.silu(x @ sh["wg"].to(dt)) \
            * (x @ sh["wu"].to(dt))
        out = out + hs @ sh["wd"].to(dt)

    # --- load-balance aux loss (Switch/GShard style) ---------------------
    me = gates.reshape(-1, E).mean(0)                      # mean router prob
    top1 = top_i[..., 0].reshape(-1, 1) == torch.arange(E, device=dev)
    ce = top1.float().mean(0)                              # top-1 load
    aux = E * (me * ce).sum() * mo.router_aux_weight
    return out, aux
