"""Spawned ranks for the port's multi-device tests (not a test module).

A test never starts a ``torch.distributed`` process group in the pytest
process: the group would leak into the next test file of that xdist
worker.  :func:`spawn` runs ``python tests/torch_ranks.py BODY WORLD OUT``
in a session of its own; that process spawns ``WORLD`` ranks, each of which
runs ``BODY(rank, world, out)`` from :mod:`torch_rank_bodies` on the CPU
and pickles what it returns to ``OUT/rank<r>.pkl``.  Bodies start their
group with :func:`init` (``gloo``, a ``file://`` rendezvous under ``OUT``,
so workers running side by side never share a port, and a timeout on the
rendezvous and every collective).  The whole spawn has a wall-clock limit:
past it every process of the session is killed and the test fails, so a
hang fails one test and cannot cut the suite.  The ranks import only
``torch`` and ``repro_torch``; the tests hold their results against the JAX
package in the pytest process.
"""
import os
import pickle
import signal
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def init(rank: int, world: int, out: str, timeout_s: float = 60.0):
    """Start this rank's process group (gloo, CPU); returns the device."""
    from repro_torch.sharding.ctx import init_distributed
    return init_distributed(init_method=f"file://{out}/rendezvous",
                            num_processes=world, process_id=rank,
                            device="cpu", timeout_s=timeout_s)


def spawn(body: str, world: int, out, timeout_s: float = 120.0):
    """Run ``body`` on ``world`` spawned ranks; returns their results, rank
    order.  Raises with the ranks' output if any rank fails or the spawn
    outlives ``timeout_s``."""
    out = str(out)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + HERE + os.pathsep \
        + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), body, str(world), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"{body} on {world} ranks outlived "
                             f"{timeout_s} s:\n{log[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{body} on {world} ranks failed "
                             f"(rc {proc.returncode}):\n{log[-6000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_main(rank: int, world: int, body: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    import torch_rank_bodies
    torch.set_num_threads(1)
    result = getattr(torch_rank_bodies, body)(rank, world, out)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    name, n, where = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_rank_main, args=(n, name, where), nprocs=n)
