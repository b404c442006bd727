#!/usr/bin/env python3
"""Times builds of ``csrc/flash_attention.cu`` against each other on one
GPU, in one process, in turns.

    python3 tools/flash_variants.py OUT.json NAME=path/to/flash_attention.cu ...

Each source is compiled with the port's own flags
(``repro_torch.kernels._build.NVCC_FLAGS``, all ``nvcc`` started together)
into ``build/flash_variants/lib<NAME>.so``, loaded with ctypes and called
through its C entry point ``flash_attention_fwd`` on the same bf16 tensors
at CASES.  Per case the builds are timed in turns, forwards then
backwards, each run after ``torch.cuda._sleep`` lets the host queue its
launches, so that CUDA events time the kernels back to back; the median of
9 runs is kept.  Every build's output is compared with the first build's
(``max_diff``).  A source may be any revision of the file: an older one
from git (``git show REV:src/repro_torch/csrc/flash_attention.cu``) or a
copy with one design choice undone.  Revisions whose C entry point takes
the keys' length T and ``causal`` (the current one) are called with T = S,
causal; older ones with their own arguments (S, no ``causal``), told apart
by the entry point's parameter list in the source.  Prints the card
(``nvidia-smi``) and a line per case, and writes every time and difference
to OUT.json.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "flash_variants"
# (B, S, Hq, Hkv, hd, window, softcap), bf16: the port's attention shapes of
# chip_smoke.py's FLASH_CASES (zamba2's hd 64, hd 128, gemma2's hd 256)
CASES = ((8, 4096, 32, 32, 64, 4096, 0.0), (1, 32768, 32, 32, 64, 4096, 0.0),
         (2, 4096, 32, 32, 64, 1024, 0.0), (1, 1024, 8, 1, 128, 0, 0.0),
         (1, 2048, 16, 4, 128, 512, 5.0), (8, 4096, 16, 4, 128, 4096, 0.0),
         (8, 4096, 8, 4, 256, 4096, 5.0), (8, 4096, 8, 4, 256, 4096, 0.0),
         (1, 32768, 8, 4, 256, 4096, 5.0), (1, 32768, 8, 4, 256, 0, 5.0),
         (4, 128, 8, 4, 256, 4096, 5.0))
RUNS = 9


def build(sources: dict) -> dict:
    """name -> loaded library, every ``nvcc`` started before the first is
    waited for; raises on a failed build."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT_DIR / f"lib{name}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        report = proc.communicate()[0]
        (OUT_DIR / f"lib{name}.log").write_text(report)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        p, i32 = ctypes.c_void_p, ctypes.c_int
        cross = takes_t(Path(sources[name]).read_text())
        lib.flash_attention_fwd.argtypes = (
            [p, p, p, p] + [i32] * (8 if cross else 6)
            + [ctypes.c_float, i32, p])
        lib.flash_attention_fwd.restype = i32
        libs[name] = (lib, cross)
    return libs


def takes_t(source: str) -> bool:
    """Whether the source's C entry point takes T and ``causal``."""
    start = source.index("int flash_attention_fwd(",
                         source.index('extern "C"'))
    return "int causal" in source[start:source.index("{", start)]


def time_case(torch, libs: dict, case) -> dict:
    B, S, Hq, Hkv, hd, window, cap = case
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(B, S, H, hd, device="cuda", generator=g)
               .bfloat16() for H in (Hq, Hkv, Hkv))
    outs = {name: torch.empty_like(q) for name in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def call(name):
        lib, cross = libs[name]
        lens = (S, S) if cross else (S,)
        flags = (window, 1) if cross else (window,)
        err = lib.flash_attention_fwd(
            outs[name].data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            B, *lens, Hq, Hkv, hd, *flags, cap, 1, stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at {case}")

    names = list(libs)
    for name in names:
        call(name)
    torch.cuda.synchronize()
    first = outs[names[0]].float()
    diff = {n: float((outs[n].float() - first).abs().max()) for n in names}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    call(names[0])
    e1.record()
    e1.synchronize()
    launches = 3 if e0.elapsed_time(e1) > 5 else 20
    times = {n: [] for n in names}
    for r in range(RUNS):
        for name in names if r % 2 == 0 else names[::-1]:
            torch.cuda._sleep(20_000_000)
            e0.record()
            for _ in range(launches):
                call(name)
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1) / launches)
    return {"case": list(case),
            "ms": {n: statistics.median(t) for n, t in times.items()},
            "max_diff": diff}


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    sources = dict(arg.split("=", 1) for arg in sys.argv[2:])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = build(sources)
    rows = []
    for case in CASES:
        row = time_case(torch, libs, case)
        rows.append(row)
        print(case, {n: round(t, 4) for n, t in row["ms"].items()},
              "max_diff", row["max_diff"], flush=True)
    Path(sys.argv[1]).write_text(json.dumps(
        {"card": card, "sources": sources, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
