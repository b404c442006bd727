"""Personalized serving driver, as in ``src/repro/launch/serve.py``.

Decode is driven through :class:`repro_torch.serving.PersonalizationServer`:
each request is a *user* with their own token stream; the server coalesces
all users' personalization (mode "B" one-step fine-tune or mode "C"
Moreau-envelope prox solve) into one pow2-bucketed cohort call, and decode
runs ``torch.func.vmap`` over the stacked per-user heads, so there is no
per-user Python loop on either side.  The prompt's first L−1 tokens warm the
cache through a loop of decode steps; the decode loop proper is step by step
because each token depends on the previous argmax.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --personalize --requests 4 --tokens 16 [--delta-dtype int8]

runs on the card (``--device cuda``, the default; ``--device cpu`` for the
CPU).  ``--smoke`` cuts the config to its CPU-sized variant.

``--personal-subset PREFIXES`` switches personalization to partial-model
(head-only) form: only the named param subtrees are personalized, banked and
stacked per user; decode merges the stacked heads over the one shared
backbone and vmaps with ``in_dims`` ``None`` on backbone leaves, so backbone
memory stays O(1) in the user count.

``--listen PORT`` swaps the one-shot decode for the socket front-end: the
server is wrapped in a :class:`repro_torch.serving.transport.TransportServer`
(wire protocol v1, the JAX package's) and other processes drive
personalization over the socket with either package's ``TransportClient``:
submit a token batch shaped as the loss expects (``{"tokens": int32[1, L],
"labels": int32[1, L]}``, L a multiple of the SSM chunk, plus a vlm
arch's ``visual`` or an encdec arch's ``frames`` leaf, see
``_user_batch``), poll the head back, fetch it again with HEAD.
``--flush-ms`` bounds queueing latency, ``--window-ms`` advances the
aggregation window on a wall clock, ``--max-inflight`` is the backpressure
bound and ``--serve-seconds`` stops the server (default: until
interrupted).  It prints ``serving personalization on 127.0.0.1:<port>
...`` once it listens, and on stopping the connections, frames, host
materializations and kernel launches of the run:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --listen 7777 --personal-subset embed/unembed --delta-dtype int8

``--model-axis M`` serves over the 2-D ``("cohort", "model")`` mesh
(:func:`repro_torch.sharding.ctx.cohort_model_mesh`): the server's engines
run ``cohort_impl="shard_map"``, and the params, ring snapshots, delta banks
and head rows are stored model-axis-sharded per
:func:`repro_torch.sharding.rules.param_shardings`.  Served bits are the
1-D path's; what the model axis buys is per-device residency.  M must
divide the world size.

Multi-process serving: ``--coordinator HOST:PORT --num-processes N
--process-id I`` starts the ``torch.distributed`` process group before any
device use (``init_method="tcp://HOST:PORT"``, ``nccl`` on the card,
``gloo`` with ``--device cpu``), one process per device, each on
``cuda:{local rank}``.  ``--coordinator`` alone implies ``--num-processes
1``; ``--model-axis`` alone starts a one-process group at the default
coordinator 127.0.0.1:12377.  Every process runs the same command with its
own ``--process-id`` and serves the same users (the ranks' collectives pair
up only when every rank submits the same requests in the same order).  With
``--listen``, as in the reference, every process starts its own transport on
the port.  A group this function started is destroyed before it returns:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --personalize --model-axis 1 --coordinator 127.0.0.1:29512 \
      --num-processes 1 --process-id 0
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.subset import SubsetSpec, merge_subset
from repro_torch.core.types import PersAFLConfig
from repro_torch.data import synthetic_token_batch
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_COORDINATOR = "127.0.0.1:12377"   # the reference's default


def _personalize_len(cfg, n: int) -> int:
    """SSM archs run the chunked SSD scan over the personalization stream,
    so the length rounds up to the next chunk multiple."""
    chunk = cfg.ssm.chunk if getattr(cfg, "ssm", None) else 1
    return -(-max(n, 1) // chunk) * chunk


def _user_batch(cfg, seed: int, length: int):
    """One user's personalization stream (numpy leaves with batch dim 1:
    int32 tokens and labels, and the reference's zero stub leaves: a vlm
    arch's ``visual`` (1, n_visual_tokens, d_model), an encdec arch's
    ``frames`` (1, enc_len, d_model); f32 here, since numpy has no bf16,
    and the model casts them to the activation dtype; the cohort engine
    stacks them and copies each leaf to the device once)."""
    batch = synthetic_token_batch(seed, 1, length, cfg.vocab)
    if cfg.n_visual_tokens:
        batch["visual"] = np.zeros((1, cfg.n_visual_tokens, cfg.d_model),
                                   np.float32)
    if cfg.is_encdec:
        batch["frames"] = np.zeros((1, cfg.enc_len, cfg.d_model), np.float32)
    return batch


def _init_batch(cfg, tokens):
    """Cache-init batch: token ids, plus an encdec arch's zero encoder
    frames (B, enc_len, d_model) in the activation dtype, on the tokens'
    device."""
    batch = {"tokens": tokens}
    if cfg.is_encdec:
        batch["frames"] = torch.zeros(
            (tokens.shape[0], cfg.enc_len, cfg.d_model),
            dtype=cfg.activation_dtype, device=tokens.device)
    return batch


def make_prefill(cfg):
    """Prompt prefill: the prompt's first L−1 tokens only warm the cache, so
    they advance through decode steps; the caller then decodes from the
    prompt's last token."""
    def prefill(params, cache, prompt):
        for t in range(prompt.shape[1] - 1):
            _, cache = api.decode_step(cfg, params, cache,
                                       prompt[:, t:t + 1], t)
        return cache
    return prefill


@torch.no_grad()
def _decode_shared(cfg, params, prompt, max_len, prompt_len):
    """Batched decode with the shared global params (no personalization)."""
    cache = api.init_cache(cfg, params, _init_batch(cfg, prompt[:, :1]),
                           max_len, cfg.activation_dtype)
    cache = make_prefill(cfg)(params, cache, prompt)
    tok = prompt[:, -1:]
    generated = []
    for pos in range(prompt_len - 1, max_len - 1):
        logits, cache = api.decode_step(cfg, params, cache, tok, pos)
        tok = logits[:, -1, :].argmax(-1)[:, None].to(torch.int32)
        generated.append(tok)
    return torch.cat(generated, dim=1) if generated else None


@torch.no_grad()
def _decode_personalized(cfg, heads, prompt, max_len, prompt_len,
                         params=None, spec=None):
    """Per-user decode: every request carries its own personalized head, so
    params, cache and tokens all vmap over the user axis (inner batch of 1).

    With a ``personal_subset`` (``spec``/``params`` given) ``heads`` is a
    stacked *subset* tree; merging it over the shared backbone gives a mixed
    tree whose personal leaves carry the user axis and whose backbone leaves
    do not, and ``in_dims`` 0 on personal leaves and ``None`` on the backbone
    vmaps it without replicating the backbone per user.

    The cache is made under the same ``vmap``, as the reference makes it:
    an encdec arch's cache holds the encoder's cross K/V, which depend on
    the params, so a user whose head holds encoder leaves runs the encoder
    on their own params (through ``FlashAttention``'s vmap rule), while a
    backbone the users share runs it once.  ``torch.func.vmap`` returns
    tensors only, so the init returns the cache's leaves and the cache is
    rebuilt around them (the hybrid's ``emb0: None`` holds no leaf).
    """
    if spec is not None:
        heads = tree_map(lambda x: x, merge_subset(params, heads))
        p_axes = tree_map(lambda m: 0 if m else None, spec.mask(params))
    else:
        p_axes = 0
    prompt_u = prompt[:, None, :]                      # [U, 1, L]
    made = {}

    def init_one(p, t):
        made["cache"] = api.init_cache(cfg, p, _init_batch(cfg, t), max_len,
                                       cfg.activation_dtype)
        return tree_leaves(made["cache"])
    leaves = vmap(init_one, in_dims=(p_axes, 0))(heads, prompt_u[:, :, :1])
    cache = tree_unflatten(made.pop("cache"), leaves)
    # the user axis on every cache tensor; an empty entry (the hybrid's
    # ``emb0: None``) is passed through, in and out.  vmap pairs axes with
    # dict entries in insertion order, so the caches it returns are rebuilt
    # by tree_map, in the sorted order the axes have.
    c_axes = tree_map(lambda _: 0, cache)
    prefill = vmap(lambda p, c, t: tree_map(lambda x: x, make_prefill(cfg)(
        p, c, t)), in_dims=(p_axes, c_axes, 0), out_dims=c_axes)

    def one_step(p, c, t, pos):
        logits, c = api.decode_step(cfg, p, c, t, pos)
        return logits, tree_map(lambda x: x, c)
    step = vmap(one_step, in_dims=(p_axes, c_axes, 0, None),
                out_dims=(0, c_axes))
    cache = prefill(heads, cache, prompt_u)
    tok = prompt_u[:, :, -1:]                          # [U, 1, 1]
    generated = []
    for pos in range(prompt_len - 1, max_len - 1):
        logits, cache = step(heads, cache, tok, pos)
        tok = logits[:, :, -1, :].argmax(-1)[..., None].to(torch.int32)
        generated.append(tok[:, 0])                    # [U, 1]
    return torch.cat(generated, dim=1) if generated else None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Personalized serving of an LM through the port's "
                    "PersonalizationServer")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4,
                    help="concurrent users (decode batch size)")
    ap.add_argument("--tokens", type=int, default=16, help="tokens to decode")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--personalize", action="store_true",
                    help="serve per-user personalized heads through "
                         "PersonalizationServer")
    ap.add_argument("--personalize-len", type=int, default=None,
                    help="per-user personalization stream length "
                         "(default: --prompt-len)")
    ap.add_argument("--mode", choices=("B", "C"), default="C",
                    help="personalization mode: B = one-step MAML "
                         "fine-tune, C = Moreau prox solve")
    ap.add_argument("--personal-subset", default=None, metavar="PREFIXES",
                    help="comma-separated param-path prefixes (checkpoint "
                         "spelling, e.g. 'embed/unembed') -- only these "
                         "leaves are personalized per user; the backbone "
                         "stays shared and is never banked")
    ap.add_argument("--delta-dtype", choices=("fp32", "int8"),
                    default="fp32",
                    help="delta banking codec: int8 quantizes banked "
                         "delta/residual rows (error feedback keeps "
                         "convergence)")
    ap.add_argument("--lam", type=float, default=30.0)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--inner-steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/serve")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    ap.add_argument("--listen", type=int, default=None, metavar="PORT",
                    help="serve personalization over a socket transport "
                         "on this port (0 = ephemeral) instead of the "
                         "one-shot decode; implies --personalize")
    ap.add_argument("--flush-ms", type=float, default=10.0,
                    help="transport deadline flush: a partial request "
                         "queue older than this is flushed by timer")
    ap.add_argument("--window-ms", type=float, default=None,
                    help="advance the aggregation window on this "
                         "wall-clock period (default: only on ADVANCE "
                         "frames)")
    ap.add_argument("--max-inflight", type=int, default=256,
                    help="transport backpressure: max open tickets "
                         "before SUBMIT gets a BUSY frame")
    ap.add_argument("--serve-seconds", type=float, default=None,
                    help="with --listen: stop after this many seconds "
                         "(default: serve until interrupted)")
    ap.add_argument("--model-axis", type=int, default=None, metavar="M",
                    help="serve over the 2-D ('cohort', 'model') mesh with "
                         "M-way model parallelism (the world size must be a "
                         "multiple of M); banks/snapshots/heads/params are "
                         "stored model-axis-sharded, served bits match the "
                         "1-D path")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="torch.distributed rendezvous address; given alone "
                         "it implies --num-processes 1")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="world size of the process group (one process per "
                         "device; every process runs the same command with "
                         "its own --process-id)")
    ap.add_argument("--process-id", type=int, default=0,
                    help="this process's rank in [0, --num-processes)")
    return ap


@dataclasses.dataclass
class ServeRun:
    """What one :func:`main` run built and measured: the JSON ``record``
    it wrote, the server (``None`` without ``--personalize``), the global
    params, the users' streams and heads, the prompt and decoded tokens,
    and the wall seconds of the params' init (drawn on the host, moved to
    the device, synced), of the personalization (submit + flush, synced)
    and of the decode."""
    cfg: object
    params: dict
    record: dict
    server: Optional[object] = None
    users: Optional[list] = None
    batches: Optional[list] = None
    heads: Optional[dict] = None
    prompt: Optional[torch.Tensor] = None
    out_tokens: Optional[torch.Tensor] = None
    personalize_s: Optional[float] = None
    decode_s: float = 0.0
    init_s: float = 0.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_counts() -> dict:
    """Kernel launches so far in this process, by kernel."""
    from repro_torch.kernels.flash_attention import kernel as KF
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.ssd import kernel as KS
    return {"ssd_fwd": KS.LAUNCHES["ssd_fwd"],
            "flash_attention_fwd": KF.LAUNCHES["flash_attention_fwd"],
            "apply_rows": K.LAUNCHES["apply_rows"],
            "apply_rows_q": K.LAUNCHES["apply_rows_q"]}


def _serve_transport(args, server) -> None:
    """Run the socket front-end until --serve-seconds elapse or ^C."""
    from repro_torch.serving.transport import (PROTOCOL_VERSION,
                                               TransportServer)
    ts = TransportServer(server, port=args.listen, flush_ms=args.flush_ms,
                         window_ms=args.window_ms,
                         max_inflight=args.max_inflight)

    async def run():
        await ts.start()
        print(f"serving personalization on 127.0.0.1:{ts.port} "
              f"(wire protocol v{PROTOCOL_VERSION}, mode {args.mode}, "
              f"flush_ms={args.flush_ms}, window_ms={args.window_ms}, "
              f"max_inflight={args.max_inflight}) on {server.device}",
              flush=True)
        try:
            if args.serve_seconds is not None:
                await asyncio.sleep(args.serve_seconds)
            else:
                await asyncio.Event().wait()
        finally:
            await ts.stop()
            print(f"transport stopped after "
                  f"{ts.stats['connections']} connections / "
                  f"{ts.stats['frames']} frames "
                  f"(host_materializations="
                  f"{server.stats['host_materializations']}, launches "
                  f"{json.dumps(_launch_counts())})", flush=True)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


def _start_group(args):
    """Start the process group the flags ask for (checked first, so a bad
    flag starts nothing); returns ``(device, started)``."""
    import torch.distributed as dist

    from repro_torch.sharding import ctx
    world = 1 if args.num_processes is None else args.num_processes
    if not 0 <= args.process_id < world:
        raise ValueError(f"--process-id {args.process_id} must lie in [0, "
                         f"--num-processes {world})")
    if args.model_axis is not None and (args.model_axis < 1
                                        or world % args.model_axis):
        raise ValueError(f"model_axis={args.model_axis} must divide the "
                         f"device count ({world})")
    coordinator = args.coordinator or _COORDINATOR
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--coordinator must be HOST:PORT, got "
                         f"{coordinator!r}")
    if args.coordinator is None and args.num_processes is None \
            and args.model_axis is None:
        return resolve_device(args.device), False
    started = not dist.is_initialized()
    dev = ctx.init_distributed(coordinator=coordinator, num_processes=world,
                               process_id=args.process_id,
                               device=args.device)
    print(f"torch.distributed: rank {dist.get_rank()}/"
          f"{dist.get_world_size()} ({dist.get_backend()}) on {dev}",
          flush=True)
    return dev, started


def main(argv=None) -> ServeRun:
    args = build_parser().parse_args(argv)
    if args.listen is not None:
        args.personalize = True
    dev, started = _start_group(args)
    try:
        return _main(args, dev)
    finally:
        if started:
            import torch.distributed as dist

            from repro_torch.sharding.ctx import reset_mesh_cache
            reset_mesh_cache()
            dist.destroy_process_group()


def _main(args, dev) -> ServeRun:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    params = api.init_params(cfg, gen, dev)
    _sync(dev)
    init_s = time.perf_counter() - t0

    B = args.requests
    max_len = args.prompt_len + args.tokens
    prompt = torch.randint(0, cfg.vocab, (B, args.prompt_len),
                           generator=gen, dtype=torch.int32).to(dev)
    run = ServeRun(cfg=cfg, params=params, record={}, prompt=prompt,
                   init_s=init_s)

    subset_spec = None
    if args.personalize:
        from repro_torch.serving import PersonalizationServer
        plen = _personalize_len(cfg, args.personalize_len
                                if args.personalize_len is not None
                                else args.prompt_len)
        loss = lambda p, b: api.loss_fn(cfg, p, b)          # noqa: E731
        pcfg = PersAFLConfig(option="C", lam=args.lam, alpha=args.alpha,
                             inner_steps=args.inner_steps, inner_eta=0.01)
        subset_spec = SubsetSpec.resolve(args.personal_subset, params)
        mesh_kw = {}
        if args.model_axis is not None:
            from repro_torch.sharding.ctx import cohort_model_mesh
            from repro_torch.sharding.rules import param_shardings
            mesh = cohort_model_mesh(args.model_axis)
            mesh_kw = {"cohort_impl": "shard_map", "mesh": mesh,
                       "param_shardings": param_shardings(cfg, params, mesh)}
            print(f"2-D mesh: cohort={mesh.shape[0]} × "
                  f"model={mesh.shape[1]} over {mesh.size()} devices",
                  flush=True)
        server = PersonalizationServer(params, loss, pcfg,
                                       modes=(args.mode,),
                                       max_pending=max(B, 1),
                                       personal_subset=subset_spec,
                                       delta_dtype=args.delta_dtype,
                                       device=dev, **mesh_kw)
        # the server holds its own copy of the params: decode and the
        # caller read that one (whole), so one copy lives on the device
        from repro_torch.sharding.ctx import gather
        params = run.params = gather(server.state.params)
        run.server = server
        if args.listen is not None:
            _serve_transport(args, server)
            return run
        run.users = [f"user{u}" for u in range(B)]
        run.batches = [_user_batch(cfg, args.seed + u, plen)
                       for u in range(B)]
        _sync(dev)
        t0 = time.perf_counter()
        # the B-th submit reaches max_pending and flushes the queue
        tickets = [server.submit(user, batch, mode=args.mode)
                   for user, batch in zip(run.users, run.batches)]
        server.flush()
        _sync(dev)
        run.personalize_s = time.perf_counter() - t0
        run.heads = server.stacked_heads([t.user for t in tickets])
        st = server.stats
        print(f"personalized {B} users through PersonalizationServer "
              f"(mode {args.mode}, len={plen}, "
              f"cohort_calls={st['cohort_calls']}, "
              f"host_materializations={st['host_materializations']}) "
              f"in {run.personalize_s:.3f}s", flush=True)

    t0 = time.perf_counter()
    if run.heads is not None:
        out_tokens = _decode_personalized(cfg, run.heads, prompt, max_len,
                                          args.prompt_len, params=params,
                                          spec=subset_spec)
    else:
        out_tokens = _decode_shared(cfg, params, prompt, max_len,
                                    args.prompt_len)
    _sync(dev)
    run.decode_s = wall = time.perf_counter() - t0
    run.out_tokens = out_tokens
    tps = B * args.tokens / wall
    print(f"decoded {args.tokens} tokens × {B} requests in {wall:.2f}s "
          f"({tps:.1f} tok/s) on {dev}", flush=True)
    if out_tokens is not None:
        print("sample:", out_tokens[0].tolist(), flush=True)
    record = {"arch": cfg.arch_id, "tok_per_s": tps,
              "personalized": args.personalize, "mode": args.mode,
              "users": B, "model_axis": args.model_axis,
              "personal_subset": (subset_spec.descriptor()
                                  if subset_spec is not None else None),
              "delta_dtype": args.delta_dtype}
    if run.server is not None:
        st = run.server.stats
        record["ring_bytes_per_user"] = st["ring_bytes_per_user"]
        record["ring_bytes_saved_per_user"] = \
            st["ring_bytes_saved_per_user"]
        record["host_materializations"] = st["host_materializations"]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"serve_{cfg.arch_id}.json"), "w") as f:
        json.dump(record, f, indent=2)
    run.record = record
    return run


if __name__ == "__main__":
    main()
