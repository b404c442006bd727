"""One round of ``launch/train.py --arch`` at the driver's defaults, and the
device memory of one gradient evaluation, on the card.

    python3 tools/train_round.py [ARCH ...]

For each arch (default: mamba2-130m and granite-moe-1b-a400m) at its
published width and (8, 512): one gradient evaluation of the LM loss through
``repro_torch.autodiff.grad`` and through ``torch.func.grad`` (whose
backward keeps its graph), each timed after a warm-up, with its peak of
device memory over the params, split by the line that allocated each block
live at the peak (``chip_smoke.memory_split``); then ``launch.train.main
--arch ARCH --rounds 1`` at the driver's defaults (Option C, Q 10, K 10): its wall, the
round's, the peak of device memory and the kernel launches.  Prints one
``TRAIN_ROUND`` line of JSON per arch.  An out-of-memory error is reported
in the line, not raised.  ``chip_smoke.py``'s (T2) runs the driver at a
cut Q and K; this measures the defaults.
"""
import json
import sys
import time


def _peak(torch, fn):
    import chip_smoke as c
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    torch.cuda.empty_cache()
    base = c.memory_record(torch)
    torch.cuda.reset_peak_memory_stats()
    try:
        fn()
        torch.cuda.synchronize()
        trace = c.memory_trace(torch)
    finally:
        c.memory_record(torch, on=False)
    return {"wall_s": walls,
            "peak_over_params_gb": (torch.cuda.max_memory_allocated()
                                    - base) / 1e9,
            "split": c.memory_split(trace, base, top=8)}


def main() -> None:
    sys.path.insert(0, "src")
    sys.path.insert(0, ".")
    import torch
    from torch.func import grad as func_grad

    from repro_torch import autodiff
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_batch
    from repro_torch.kernels.flash_attention import kernel as KF
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.ssd import kernel as KS
    from repro_torch.launch import train
    from repro_torch.models import api
    archs = sys.argv[1:] or ["mamba2-130m", "granite-moe-1b-a400m"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in archs:
        cfg = get_config(arch)
        out = {"arch": arch, "card": torch.cuda.get_device_name(0)}
        with torch.device("cuda"):
            params = api.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 synthetic_token_batch(0, 8, 512, cfg.vocab).items()}

        def loss(p, b):
            return api.loss_fn(cfg, p, b)
        for name, g in (("autodiff.grad", autodiff.grad(loss)),
                        ("torch.func.grad", func_grad(loss))):
            try:
                out[name] = _peak(torch, lambda: g(params, batch))
            except torch.OutOfMemoryError as exc:
                out[name] = {"oom": str(exc)[:200]}
            torch.cuda.empty_cache()
        del params, batch
        torch.cuda.empty_cache()
        for mod in (K, KS, KF):
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            run = train.main(["--arch", arch, "--rounds", "1",
                              "--out", "build/train"])
            torch.cuda.synchronize()
            out["driver_defaults"] = {
                "wall_s": time.perf_counter() - t0,
                "round_s": run.round_s, "losses": run.record["losses"],
                "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {"ssd_fwd": KS.LAUNCHES["ssd_fwd"],
                             "flash_attention_fwd":
                                 KF.LAUNCHES["flash_attention_fwd"],
                             "apply_scaled": K.LAUNCHES["apply_scaled"]}}
            del run
        except torch.OutOfMemoryError as exc:
            out["driver_defaults"] = {
                "oom": str(exc)[:200],
                "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.empty_cache()
        print("TRAIN_ROUND " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
