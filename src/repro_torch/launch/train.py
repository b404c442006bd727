"""PersA-FL training driver, as in ``src/repro/launch/train.py``.

Two modes:
  * ``--preset paper-mnist|paper-cifar`` -- the paper's §5 experiment:
    asynchronous personalized FL over n heterogeneous clients with the
    paper's CNNs, driven by the :class:`repro_torch.fl.FLRun` event loop
    with the paper-faithful ``immediate()`` apply schedule (every apply one
    ``apply_scaled`` launch on the card).  It writes the server state to
    ``<out>/<preset>_opt<option>`` in the JAX package's checkpoint layout and
    its history beside it (``.history.json``).
  * ``--arch <id> [--smoke]`` -- PersA-FL over an LLM architecture
    (:func:`repro_torch.launch.steps.make_train_step`): the full config at
    (B, S) = (8, 512), or with ``--smoke`` its CPU-sized variant at
    ``--batch`` × ``--seq``; it prints ``round r: loss=… delta_norm=…`` and
    writes ``<out>/train_<arch>.json``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --preset paper-mnist \\
      --option C --rounds 200
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --rounds 4 --device cpu

The flags and outputs are the reference's, plus ``--device`` (default
``cuda``, the card; ``cpu`` runs on the CPU).  The params are drawn from a
``torch.Generator`` seeded from ``--seed`` (the reference's shapes and init
laws, not its numbers: ``jax.random`` draws cannot be reproduced); the data
are the reference's numpy streams bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_server_state
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.paper_models import CIFAR_CNN, MNIST_CNN
from repro_torch.core import PersAFLConfig
from repro_torch.data import make_federated_dataset, synthetic_token_batch
from repro_torch.device import resolve_device
from repro_torch.fl import DelayModel, FLRun, immediate, make_personalized_eval
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn


@dataclasses.dataclass
class TrainRun:
    """What one run built: the ``record`` it wrote as JSON (the reference's
    return value), the preset's ``FLRun``, or the arch's final params and
    the wall seconds of each round (its train step and its loss evaluation,
    ending in the loss's copy to the host)."""
    record: dict
    run: Optional[FLRun] = None
    params: Optional[dict] = None
    round_s: List[float] = dataclasses.field(default_factory=list)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_paper_preset(args) -> TrainRun:
    dev = resolve_device(args.device)
    kind = "mnist" if args.preset == "paper-mnist" else "cifar"
    ccfg = MNIST_CNN if kind == "mnist" else CIFAR_CNN
    cpc = 5 if kind == "mnist" else 3  # c classes per client (paper §5)
    clients = make_federated_dataset(kind, n_clients=args.clients,
                                     classes_per_client=cpc, seed=args.seed)
    params = init_cnn(ccfg, torch.Generator().manual_seed(args.seed))

    def loss(p, b):
        return cnn_loss(ccfg, p, b, train=False)

    def acc(p, b):
        return cnn_accuracy(ccfg, p, b)

    ev = make_personalized_eval(loss, acc, clients, ft_steps=1,
                                ft_lr=args.eta)
    pcfg = PersAFLConfig(option=args.option, q_local=args.q, eta=args.eta,
                         beta=args.beta, alpha=args.alpha, lam=args.lam,
                         inner_steps=args.inner_steps,
                         maml_mode=args.maml_mode)
    sim = FLRun(clients=clients, loss_fn=loss, init_params=params,
                pcfg=pcfg, delays=DelayModel(args.clients, seed=args.seed,
                                             scale=args.delay_scale),
                strategy="persafl", schedule=immediate(),
                batch_size=args.batch, seed=args.seed, device=dev)
    t0 = time.time()
    hist = sim.run(max_rounds=args.rounds,
                   eval_every=args.eval_every, eval_fn=ev)
    _sync(dev)
    wall = time.time() - t0
    out = {
        "preset": args.preset, "option": args.option, "rounds": args.rounds,
        "acc": hist.acc, "times": hist.times, "rounds_series": hist.rounds,
        "mean_active_ratio": float(np.mean(hist.active_ratio)),
        "staleness_max": int(max(hist.staleness)) if hist.staleness else 0,
        "staleness_mean": float(np.mean(hist.staleness))
        if hist.staleness else 0,
        "wall_s": wall,
    }
    os.makedirs(args.out, exist_ok=True)
    ckpt = os.path.join(args.out, f"{args.preset}_opt{args.option}")
    save_server_state(ckpt, sim.state, meta=out)
    with open(ckpt + ".history.json", "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("times", "rounds_series")}, indent=2))
    return TrainRun(record=out, run=sim)


def run_arch(args) -> TrainRun:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    pcfg = PersAFLConfig(option=args.option, q_local=args.q, eta=args.eta,
                         lam=args.lam, inner_steps=args.inner_steps,
                         maml_mode=cfg.maml_mode)
    # drawn where they live: the init's laws from a generator on `dev`
    with torch.device(dev):
        params = api.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    step = make_train_step(cfg, pcfg, n_microbatches=1)
    B, S = (args.batch, args.seq) if args.smoke else (8, 512)
    act = cfg.activation_dtype
    losses, round_s = [], []
    _sync(dev)
    t0 = time.time()
    for r in range(args.rounds):
        t_round = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 synthetic_token_batch(args.seed + r, B, S,
                                       cfg.vocab).items()}
        if cfg.n_visual_tokens:
            batch["visual"] = torch.zeros((B, cfg.n_visual_tokens,
                                           cfg.d_model), dtype=act,
                                          device=dev)
        if cfg.is_encdec:
            batch["frames"] = torch.zeros((B, cfg.enc_len, cfg.d_model),
                                          dtype=act, device=dev)
        # paper-faithful: the delta is computed at the (here: current)
        # downloaded params; staleness comes from the event schedule.  The
        # server apply writes a new tree, so the one tree may be both.
        params, metrics = step(params, params, batch)
        with torch.no_grad():
            losses.append(float(api.loss_fn(cfg, params, batch)))
        round_s.append(time.perf_counter() - t_round)
        print(f"round {r}: loss={losses[-1]:.4f} "
              f"delta_norm={float(metrics['delta_norm']):.4f}", flush=True)
    out = {"arch": cfg.arch_id, "losses": losses,
           "wall_s": time.time() - t0}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"train_{cfg.arch_id}.json"), "w") as f:
        json.dump(out, f, indent=2)
    return TrainRun(record=out, params=params, round_s=round_s)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="PersA-FL training: the paper's preset experiment or "
                    "an LLM architecture")
    ap.add_argument("--preset", default=None,
                    choices=[None, "paper-mnist", "paper-cifar"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--option", default="C", choices=["A", "B", "C"])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--eta", type=float, default=0.01)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--lam", type=float, default=30.0)
    ap.add_argument("--inner-steps", type=int, default=10)
    ap.add_argument("--maml-mode", default="full")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--delay-scale", type=float, default=1.0)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/train")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    return ap


def main(argv=None) -> TrainRun:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.preset:
        return run_paper_preset(args)
    if args.arch:
        return run_arch(args)
    ap.error("need --preset or --arch")


if __name__ == "__main__":
    main()
