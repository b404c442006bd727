"""Builds the port's CUDA C++ kernels with ``nvcc`` and loads them with ctypes.

A library ``<name>`` is the one source ``csrc/<name>.cu`` (``fused_update``,
``ssd``, ``flash_attention``), with a plain C interface, compiled for
Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/lib<name>-<hash>.so ...

into ``build/repro_torch/`` at the root of the checkout, at first use.  The
file name carries a hash of the source and the flags, so a checkout builds
what it holds and an unchanged source loads the library already built.
``nvcc``'s report (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``<same name>.log``.

:func:`build_all` starts one ``nvcc`` process per source, all at once, and
then waits for each.  Nothing is built or loaded when a module is imported.
A missing ``nvcc`` or a failed build raises; no caller falls back to a plain
version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from the toolkit PyTorch found."""
    nvcc = shutil.which("nvcc")
    if nvcc is not None:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "repro_torch: nvcc not found on PATH or under CUDA_HOME; the CUDA "
        "kernels are built from csrc/ at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built for its source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for library ``name``; ``None`` if this source hash is
    built already."""
    out = library_path(name)
    if out.is_file():
        return None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename, so that another process never
    # loads a half-written file
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp, out


def _finish(name: str, started) -> Path:
    """Wait for the ``nvcc`` that :func:`_start` began; raise if it failed."""
    if started is None:
        return library_path(name)
    proc, cmd, tmp, out = started
    report = proc.communicate()[0]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"repro_torch: nvcc failed with code "
                           f"{proc.returncode}: {' '.join(cmd)}\n{report}")
    out.with_suffix(".log").write_text(report)
    os.replace(tmp, out)
    return out


def build(name: str) -> Path:
    """Compile library ``name`` unless this source hash is built already."""
    return _finish(name, _start(name))


def build_all(names: Iterable[str]) -> List[Path]:
    """:func:`build` for every library in ``names``: all the compilers are
    started before the first is waited for, and all are waited for before
    the first failure is raised."""
    started = [(name, _start(name)) for name in names]
    paths, errors = [], []
    for name, st in started:
        try:
            paths.append(_finish(name, st))
        except RuntimeError as exc:
            errors.append(exc)
    if errors:
        raise errors[0]
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if need be (once per
    process)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
