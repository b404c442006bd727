#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

  1. build   -- ``nvcc`` builds the kernel library from
     ``src/repro_torch/csrc/fused_update.cu``.
  2. kernels -- each CUDA kernel against its plain PyTorch version on the
     card, on the same inputs, within TOLS: at the main path's shapes (the
     8 leaves of the paper's MNIST CNN) and at bank-sized shapes, f32, bf16
     and f32 params with bf16 deltas.  Each case also shows that a no-op
     and a sign-flipped result fail the same check.  Times are medians of
     CUDA-event timings; ``bound_ms`` is the bytes the function must move
     over the H100 SXM's 3.35 TB/s; ``library_ms`` times one PyTorch call
     that computes the same function (a yardstick the port never calls).
  3. main path -- PersA-FL asynchronous training of the paper CNN on
     label-skewed synthetic MNIST (the fig2 setup of
     ``benchmarks/common.py``: 30 clients, 5 classes each, batch 16, Q = 10,
     λ = 25, 10 inner steps) through ``FLRun(device="cuda")``:
     (a) Option C, immediate, 75 rounds; (b) Option C, buffered(8), 80
     rounds; (c) Option B full, immediate, 10 rounds; (d) Option A,
     η = 0.01, sync_barrier(10), 5 rounds.  The launch counters are zeroed
     just before (a) and read just after (d).
  4. checks  -- both kernels were launched in (a)-(d), params are finite,
     and the first 8 rounds of (a) and (b), run on the card and on the CPU,
     give the same event timeline and params within PARAM_ATOL.

It prints the card's name and power limit first, one ``{"kernels": [...]}``
line before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
SOURCE = "src/repro_torch/csrc/fused_update.cu"
REPLACES = {"apply_scaled": "src/repro/kernels/fused_update/kernel.py:229",
            "apply_rows": "src/repro/kernels/fused_update/kernel.py:129"}
# CPU-vs-card agreement of the 8-round runs.  The card's cuDNN and the CPU's
# oneDNN sum the f32 convolutions in different orders, so every gradient
# differs in its last bits; Option C then forms λ(w − θ̃) from two nearly
# equal params (λ = 25), which magnifies those bits, and each round chains
# Q = 10 steps of 11 gradients onto params that the earlier rounds already
# moved.  An H100 run of (a) differed from the CPU by 5.7e-5 at most.
PARAM_ATOL = 1e-4
# params that far apart move the logits enough to flip near-ties: allow 1%
# of the 30 x 64 personalized test predictions (an H100 run of (a) flipped
# 4 of them, 0.0021)
ACC_ATOL = 0.01
# kernel against plain version on the card.  f32 apply_scaled: one
# elementwise f32 pass, rounded as the plain version rounds it.  f32
# apply_rows: the M rows are summed in another order.  bf16 output: about
# one bf16 ulp (8 significant bits), for a sum rounded from a slightly
# different f32 value.  Every case checks that a no-op and a sign-flipped
# result fail these limits.
TOLS = {"apply_scaled": dict(atol=1e-6, rtol=0.0),
        "apply_rows": dict(atol=1e-5, rtol=1e-4),
        "bf16": dict(atol=1e-5, rtol=2.0 ** -7)}
# bank-sized kernel cases, (n, w dtype, d dtype) and (M, n, w dtype, d
# dtype), beside the CNN's leaves.  Ragged n leaves a tail past every
# vector width; M = 1500 crosses apply_rows' 1024-row weight chunk; w f32
# with d bf16 is what PersAFLConfig(delta_dtype="bfloat16") hands both
# kernels.
SCALED_CASES = ((2 ** 26 + 3, "f32", "f32"), (2 ** 26 + 3, "bf16", "bf16"),
                (2 ** 26 + 3, "f32", "bf16"))
ROWS_CASES = ((1, 2 ** 20 + 5, "f32", "f32"), (8, 2 ** 20 + 5, "f32", "f32"),
              (300, 2 ** 20 + 5, "f32", "f32"),
              (1500, 2 ** 18 + 5, "f32", "f32"), (8, 2 ** 24, "f32", "f32"),
              (8, 2 ** 20 + 5, "bf16", "bf16"),
              (8, 2 ** 20 + 5, "f32", "bf16"))
FIG2 = dict(q_local=10, beta=1.0, alpha=0.01, lam=25.0, inner_steps=10,
            inner_eta=0.02, maml_mode="full")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, launches: int = 20, repeats: int = 5) -> float:
    """Time of one call of ``fn``: CUDA events around ``launches`` calls in
    a row, over the count, median of ``repeats`` such runs.  Where a call's
    host work outlasts its kernel, this is the host's time per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def kernel_phase(torch, cnn_shapes):
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update import ref as R

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    f32, bf16 = torch.float32, torch.bfloat16
    results = {"apply_scaled": [], "apply_rows": []}

    def randn(*shape, scale=1.0, dtype=f32):
        return (scale * torch.randn(*shape, device=dev, generator=g)
                ).to(dtype)

    def row_weights(m):
        # β/M-like weights, scaled so that Σᵢ sᵢ·Δᵢ is of the order of w;
        # every third row weighs 0 and must stay inert
        sw = torch.rand(m, device=dev, generator=g) / m ** 0.5
        sw[1::3] = 0.0
        return sw

    def close(name, got, want):
        """Max abs error, and whether every leaf is within tolerance."""
        err = max(float((a.float() - b.float()).abs().max()) if a.numel()
                  else 0.0 for a, b in zip(got, want))
        tol = TOLS["bf16" if want[0].dtype == bf16 else name]
        ok = all(torch.allclose(a.float(), b.float(), **tol)
                 for a, b in zip(got, want))
        return err, ok

    def run_case(name, label, ws, ds, extra):
        """One shape: a list of leaves, applied one launch per leaf."""
        if name == "apply_scaled":
            s = extra
            kern = lambda: [K.apply_scaled(w, d, s) for w, d in zip(ws, ds)]  # noqa
            plain = lambda: [R.apply_scaled_ref(w, d, s)  # noqa: E731
                             for w, d in zip(ws, ds)]
            lib = lambda: [torch.add(w, d, alpha=-s)  # noqa: E731
                           for w, d in zip(ws, ds)]
            nbytes = sum(2 * w.numel() * w.element_size()
                         + d.numel() * d.element_size()
                         for w, d in zip(ws, ds))
        else:
            sw = extra
            swl = sw.to(ws[0].dtype)
            kern = lambda: [K.apply_rows(w, d, sw) for w, d in zip(ws, ds)]  # noqa
            plain = lambda: [R.apply_rows_ref(w, d, sw)  # noqa: E731
                             for w, d in zip(ws, ds)]
            # addmv takes one dtype: no single library call for mixed types
            lib = None if ds[0].dtype != ws[0].dtype else (
                lambda: [torch.addmv(w.view(-1), d.view(d.shape[0], -1).t(),
                                     swl, alpha=-1) for w, d in zip(ws, ds)])
            nbytes = sum(2 * w.numel() * w.element_size()
                         + d.numel() * d.element_size() + 4 * sw.numel()
                         for w, d in zip(ws, ds))
        want = plain()
        # A kernel that left an output element unwritten (a ragged tail)
        # would hand back what the allocator's block held before: make that
        # NaN, which no check passes.  With the cache emptied first, the
        # wrapper's torch.empty gets the blocks just freed, since it asks
        # for the same sizes on the same stream.
        torch.cuda.empty_cache()
        poison = [torch.full_like(w, float("nan")) for w in ws]
        del poison
        got = kern()
        torch.cuda.synchronize()
        err, ok = close(name, got, want)
        check(ok, f"{name} {label}: kernel disagrees with its plain version "
                  f"(max abs err {err})")
        # the check must reject a kernel that returns w unchanged, and one
        # that adds the update instead of subtracting it
        noop_err, noop_ok = close(name, ws, want)
        flipped = [(2 * w.float() - o.float()).to(w.dtype)
                   for w, o in zip(ws, want)]
        flip_err, flip_ok = close(name, flipped, want)
        check(not noop_ok and not flip_ok,
              f"{name} {label}: the tolerance cannot tell a no-op "
              f"(err {noop_err}) or a sign flip (err {flip_err}) from the "
              f"plain version")
        del got, want, flipped
        row = {"shape": label, "max_abs_err": err,
               "noop_err": noop_err, "sign_flip_err": flip_err,
               "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "library_ms": None if lib is None else time_ms(torch, lib),
               "launches_per_call": len(ws)}
        results[name].append(row)
        print(f"kernel {name} {label}: {json.dumps(row)}", flush=True)

    dtypes = {"f32": f32, "bf16": bf16}

    def dname(dw, dd):
        return dw if dw == dd else f"w {dw} d {dd}"

    # the main path's shapes: the MNIST CNN's 8 leaves, one launch each
    ws = [randn(*sh, scale=0.5) for sh in cnn_shapes]
    ds = [randn(*sh, scale=0.5) for sh in cnn_shapes]
    run_case("apply_scaled", "MNIST_CNN 8 leaves f32", ws, ds, 0.7)
    for m in (8, 16, 64):
        stacks = [randn(m, *sh) for sh in cnn_shapes]
        run_case("apply_rows", f"MNIST_CNN 8 leaves M={m} f32", ws, stacks,
                 row_weights(m))
    del ws, ds, stacks
    for n, dw, dd in SCALED_CASES:
        w = randn(n, scale=0.5, dtype=dtypes[dw])
        d = randn(n, scale=0.5, dtype=dtypes[dd])
        run_case("apply_scaled", f"n={n} {dname(dw, dd)}", [w], [d], 0.7)
        del w, d
    for m, n, dw, dd in ROWS_CASES:
        w = randn(n, scale=0.5, dtype=dtypes[dw])
        d = randn(m, n, dtype=dtypes[dd])
        sw = row_weights(m)
        if m > 1024:
            # past the kernel's 1024-row chunk of staged weights: zero rows
            # on both sides of the boundary
            sw[1018:1030] = 0.0
        run_case("apply_rows", f"M={m} n={n} {dname(dw, dd)}", [w], [d], sw)
        del w, d
    torch.cuda.empty_cache()
    return results


def immediate_apply_ms(torch, params_cpu):
    """One immediate apply as the main path runs it: a host row of a
    materialized bank copied to the card, then one launch per leaf."""
    from repro_torch.core import apply_update, init_server_state
    from repro_torch.tree import tree_map
    state = init_server_state(params_cpu, device="cuda")
    row = tree_map(lambda x: 0.01 * x, params_cpu)
    return time_ms(torch, lambda: apply_update(state, row, 1.0, 3))


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def fig2_setup(torch):
    from repro_torch.configs.paper_models import MNIST_CNN
    from repro_torch.data import make_federated_dataset
    from repro_torch.fl import make_personalized_eval
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn
    clients = make_federated_dataset("mnist", n_clients=30,
                                     classes_per_client=5, seed=0)
    params = init_cnn(MNIST_CNN, torch.Generator().manual_seed(0))
    loss = lambda p, b: cnn_loss(MNIST_CNN, p, b, train=False)  # noqa: E731
    acc = lambda p, b: cnn_accuracy(MNIST_CNN, p, b)  # noqa: E731
    ev = make_personalized_eval(loss, acc, clients, ft_steps=1, ft_lr=0.01)
    return clients, params, loss, ev


RUNS = {
    # name: (option, eta, schedule, rounds, eval_every)
    "a": ("C", 0.002, ("immediate",), 75, 15),
    "b": ("C", 0.002, ("buffered", 8), 80, 16),
    "c": ("B", 0.002, ("immediate",), 10, 5),
    "d": ("A", 0.01, ("sync_barrier", 10), 5, 1),
}


def make_run(torch, setup, name, device):
    from repro_torch.core import PersAFLConfig
    from repro_torch.fl import (DelayModel, FLRun, buffered, immediate,
                                strategy, sync_barrier)
    clients, params, loss, _ = setup
    option, eta, sched, _, _ = RUNS[name]
    schedule = {"immediate": immediate, "buffered": buffered,
                "sync_barrier": sync_barrier}[sched[0]](*sched[1:])
    return FLRun(clients=clients, loss_fn=loss, init_params=params,
                 pcfg=PersAFLConfig(option=option, eta=eta, **FIG2),
                 delays=DelayModel(len(clients), seed=0),
                 strategy=strategy("persafl", option=option),
                 schedule=schedule, batch_size=16, seed=0, device=device)


def finite(torch, params) -> bool:
    from repro_torch.tree import tree_leaves
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(params))


def main_path(torch, setup):
    """Runs (a)-(d) on the card; returns their launch counts and
    histories."""
    from repro_torch.kernels.fused_update import kernel as K
    ev = setup[3]
    hists = {}
    K.reset_launches()
    for name in RUNS:
        run = make_run(torch, setup, name, "cuda")
        _, _, _, rounds, every = RUNS[name]
        t0 = time.perf_counter()
        hist = run.run(max_rounds=rounds, eval_every=every, eval_fn=ev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hists[name] = hist
        check(finite(torch, run.params), f"run ({name}): params not finite")
        check(hist.acc and all(0.0 <= a <= 1.0 for a in hist.acc),
              f"run ({name}): accuracy trajectory {hist.acc}")
        print(f"main path ({name}) {RUNS[name][:3]} rounds={rounds}: "
              f"wall {wall:.3f} s, acc {[round(a, 4) for a in hist.acc]}, "
              f"mean active ratio {float(sum(hist.active_ratio)) / max(len(hist.active_ratio), 1):.4f}, "
              f"max staleness {max(hist.staleness, default=0)}, "
              f"stats {json.dumps(run.stats)}", flush=True)
    launches = dict(K.LAUNCHES)
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    return launches, hists


def profile_phase(torch, setup, rounds: int = 10):
    """Device busy share of the first ``rounds`` rounds of (a) under
    ``torch.profiler``: the CUDA kernels' summed time over the wall time."""
    from torch.profiler import ProfilerActivity, profile
    run = make_run(torch, setup, "a", "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.run(max_rounds=rounds, eval_every=rounds, eval_fn=setup[3])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us()
    top5 = sorted(top.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile (a) {rounds} rounds: wall {wall:.3f} s, device kernels "
          f"{len(kernels)}, device busy {busy_us / 1e6:.3f} s "
          f"({100 * busy_us / 1e6 / wall:.2f}% of wall), top "
          f"{json.dumps([(n[:60], round(t / 1e3, 3)) for n, t in top5])} "
          f"(ms)", flush=True)


def cpu_parity(torch, setup, main_hists):
    """The first 8 rounds of (a) and (b) on the card (twice) and on the
    CPU: identical timelines, also against the main path's own runs, and
    params within PARAM_ATOL."""
    from repro_torch.tree import tree_leaves
    for name in ("a", "b"):
        out = {}
        for device in ("cuda", "cuda", "cpu"):
            run = make_run(torch, setup, name, device)
            t0 = time.perf_counter()
            hist = run.run(max_rounds=8, eval_every=4, eval_fn=setup[3])
            out.setdefault(device, []).append(
                (hist, run, time.perf_counter() - t0))
        (hg, rg, tg), (_, rg2, _) = out["cuda"]
        (hc, rc, tc), = out["cpu"]
        spread = max(float((a - b).abs().max())
                     for a, b in zip(tree_leaves(rg.params),
                                     tree_leaves(rg2.params)))
        for field in ("times", "rounds", "staleness", "active_times",
                      "active_ratio", "end_time"):
            check(getattr(hg, field) == getattr(hc, field),
                  f"({name}) 8 rounds: {field} differs between card and CPU")
        # the 8-round timeline is a prefix of the main path's run (evals
        # aside, which follow eval_every)
        for field in ("staleness", "active_times", "active_ratio"):
            full = getattr(main_hists[name], field)
            check(full[:len(getattr(hc, field))] == getattr(hc, field),
                  f"({name}) 8 rounds: {field} is not a prefix of the "
                  f"main path's run")
        diff = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(tree_leaves(rg.params),
                                   tree_leaves(rc.params)))
        acc_diff = max((abs(a - b) for a, b in zip(hg.acc, hc.acc)),
                       default=0.0)
        print(f"parity ({name}) 8 rounds: timeline identical "
              f"(staleness {hg.staleness}), max |param diff| {diff:.3e} "
              f"(tol {PARAM_ATOL}), card vs card {spread:.3e}, acc card {hg.acc} cpu {hc.acc}, "
              f"wall card {tg:.3f} s cpu {tc:.3f} s", flush=True)
        check(diff <= PARAM_ATOL, f"({name}) params differ by {diff}")
        check(acc_diff <= ACC_ATOL, f"({name}) accuracy differs by "
                                    f"{acc_diff}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              f"this script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    try:
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        path = _build.build("fused_update")
        print(f"build: {time.perf_counter() - t0:.2f} s {path.name}",
              flush=True)
        log = path.with_suffix(".log")
        if log.is_file():
            print(log.read_text().strip(), flush=True)

        setup = fig2_setup(torch)
        from repro_torch.tree import tree_leaves
        cnn_shapes = [tuple(x.shape) for x in tree_leaves(setup[1])]
        results = kernel_phase(torch, cnn_shapes)
        imm_ms = immediate_apply_ms(torch, setup[1])
        print(f"immediate apply as the main path runs it (H2D copy of one "
              f"host row + {len(cnn_shapes)} launches): {imm_ms:.4f} ms",
              flush=True)

        launches, hists = main_path(torch, setup)
        profile_phase(torch, setup)
        cpu_parity(torch, setup, hists)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    kernels = []
    for name, rows in results.items():
        main = rows[0]          # the main path's shape comes first
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "shapes": rows})
    kernels[0]["immediate_apply_ms"] = imm_ms
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
