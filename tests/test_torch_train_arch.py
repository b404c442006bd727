"""``run_arch --smoke`` of the port's training driver against the
reference's: mamba2-130m here and granite-moe-1b-a400m in
``test_torch_train_arch_moe.py`` (one file each, for time), at
``reduce_for_smoke``, 2 rounds of Option C at ``--q 2 --inner-steps 2
--batch 2 --seq 32``.  The port's ``api.init_params``, as
``launch/train.py`` sees it, returns the JAX init (the reference's driver
draws it from ``PRNGKey(seed)``, here under ``jax.jit`` in both drivers)
carried across by ``params_from_jax``; the token batches are the same
numpy streams.  The per-round losses within rtol 1e-5 and each round's
``delta_norm`` (read from the step's metrics in both packages: the
reference's through ``jax.debug.callback`` inside its jitted step) within
rtol 1e-5, each also failing a zero and a sign-flipped value; the
``train_<arch>.json`` record with the reference's keys.
"""
import json

import jax
import numpy as np

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import api as japi
from repro_torch.convert import params_from_jax
from repro_torch.launch import train
from test_torch_train import _holds, _one_torch_thread  # noqa: F401

RTOL = 1e-5
ARGS = ("--smoke", "--rounds", "2", "--q", "2", "--inner-steps", "2",
        "--batch", "2", "--seq", "32", "--device", "cpu")


def _recording(make, seen):
    """``make_train_step`` whose steps hand each round's delta_norm to
    ``seen`` (as a host float)."""
    def make_train_step(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(server, stale, batch):
            new, metrics = step(server, stale, batch)
            if isinstance(metrics["delta_norm"], jax.Array):
                jax.debug.callback(lambda v: seen.append(float(v)),
                                   metrics["delta_norm"])
            else:
                seen.append(float(metrics["delta_norm"]))
            return new, metrics
        return recorded
    return make_train_step


def check_run_arch(arch, tmp_path, monkeypatch):
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    # the reference's init compiled once (eager, its draws compile op by
    # op): the same numbers for both drivers
    jinit = jax.jit(japi.init_params, static_argnums=0)
    init = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(japi, "init_params", jinit)
    argv = ["--arch", arch, *ARGS]
    jseen, tseen = [], []
    monkeypatch.setattr(jsteps, "make_train_step",
                        _recording(jsteps.make_train_step, jseen))
    want = jtrain.run_arch(train.build_parser().parse_args(
        argv + ["--out", str(tmp_path / "jax")]))
    monkeypatch.setattr(train.api, "init_params",
                        lambda cfg, gen, dev: params_from_jax(init, dev))
    monkeypatch.setattr(train, "make_train_step",
                        _recording(train.make_train_step, tseen))
    got = train.run_arch(train.build_parser().parse_args(
        argv + ["--out", str(tmp_path / "torch")]))
    rec = got.record
    assert set(rec) == set(want) and rec["arch"] == want["arch"] == arch
    _holds(rec["losses"], want["losses"], atol=0.0, rtol=RTOL)
    assert len(jseen) == len(tseen) == 2
    _holds(tseen, jseen, atol=0.0, rtol=RTOL)
    with open(tmp_path / "torch" / f"train_{arch}.json") as f:
        assert json.load(f) == rec


def test_run_arch_smoke_matches_reference(tmp_path, monkeypatch):
    check_run_arch("mamba2-130m", tmp_path, monkeypatch)
