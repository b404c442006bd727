"""Port of the training driver (``repro_torch.launch.train``) against
``repro.launch.train``.

``run_paper_preset`` runs paper-mnist in both packages at ``--rounds 6 --q 2
--inner-steps 2 --eval-every 3 --clients 6`` (the paper's 30 clients cost
the reference's cohort compiles ~10 s more; ``test_torch_train_cifar.py``
runs paper-cifar at 3 rounds): the port's ``init_cnn``, as
``launch/train.py`` sees it, returns the JAX init carried across by
``params_from_jax`` (the reference's ``init_cnn`` under ``jax.jit``, in
both drivers).  The history's timeline (``times``, ``rounds_series``),
staleness and active ratio must be equal, the accuracy within 0.01 (of 6 ×
64 test predictions), the params within 1e-4 absolute: their change over the
run within 1e-4, a zero and a sign-flipped change failing it.  The port's
checkpoint loads in the JAX package (``repro.checkpoint.load_server_state``)
equal to the port's ``FLRun`` state, and its history and meta JSON equal the
returned record.

``main`` refuses to run with neither mode, runs on the CPU with ``--device
cpu`` and, without ``--device``, asks for the card (here: raises).
``test_torch_train_arch.py`` holds ``run_arch --smoke`` against the JAX
``run_arch``.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs.paper_models import CIFAR_CNN as J_CIFAR
from repro.configs.paper_models import MNIST_CNN as J_MNIST
from repro.launch import train as jtrain
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_jax
from repro_torch.launch import train
from repro_torch.tree import tree_leaves

PARAM_ATOL = 1e-4
ACC_ATOL = 0.01
PRESET_ARGS = ("--q", "2", "--inner-steps", "2", "--eval-every", "3",
               "--clients", "6", "--device", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _holds(got, want, atol, rtol=0.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    assert not np.allclose(np.zeros_like(want), want, atol=atol, rtol=rtol)
    assert not np.allclose(-want, want, atol=atol, rtol=rtol)


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


def check_preset(tmp_path, monkeypatch, preset, rounds):
    """Both drivers' ``run_paper_preset`` from one JAX init; returns the
    port's run and the two checkpoint paths."""
    argv = ["--preset", preset, "--rounds", str(rounds), *PRESET_ARGS]
    jargs = train.build_parser().parse_args(
        argv + ["--out", str(tmp_path / "jax")])
    targs = train.build_parser().parse_args(
        argv + ["--out", str(tmp_path / "torch")])
    ccfg = J_MNIST if preset == "paper-mnist" else J_CIFAR
    # the reference's init, compiled once (its driver's eager draws compile
    # op by op, ~7 s here): the same numbers for both drivers
    jinit = jax.jit(jcnn.init_cnn, static_argnums=0)
    init = jax.tree.map(np.asarray, jinit(ccfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(jtrain, "init_cnn", jinit)
    want = jtrain.run_paper_preset(jargs)
    monkeypatch.setattr(train, "init_cnn",
                        lambda cfg, gen: params_from_jax(init, "cpu"))
    got = train.run_paper_preset(targs)
    rec = got.record
    assert set(rec) == set(want)
    for key in ("preset", "option", "rounds", "times", "rounds_series",
                "mean_active_ratio", "staleness_max", "staleness_mean"):
        assert rec[key] == want[key], key
    assert len(rec["acc"]) == len(want["acc"]) == rounds // 3
    np.testing.assert_allclose(rec["acc"], want["acc"], atol=ACC_ATOL,
                               rtol=0)
    assert rec["staleness_max"] > 0 and 0 < rec["mean_active_ratio"] < 1
    name = f"{preset}_optC"
    jpath, tpath = (str(tmp_path / d / name) for d in ("jax", "torch"))
    jstate = jckpt.load_server_state(jpath)
    w0 = _flat(jax.tree.leaves(init))
    _holds(_flat(x.numpy() for x in tree_leaves(got.run.state.params)) - w0,
           _flat(jax.tree.leaves(jstate.params)) - w0, atol=PARAM_ATOL)
    assert int(jstate.t) == int(got.run.state.t) == rounds
    return got, jpath, tpath


def test_paper_mnist_preset_matches_reference(tmp_path, monkeypatch):
    got, jpath, tpath = check_preset(tmp_path, monkeypatch, "paper-mnist", 6)
    # the port's checkpoint in the JAX package: the run's state, exactly
    state = jckpt.load_server_state(tpath)
    run = got.run.state
    for a, b in zip(jax.tree.leaves(state.params),
                    tree_leaves(run.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(state.t).dtype == np.int32 and state.t == run.t
    assert state.staleness_max == run.staleness_max
    assert state.staleness_sum == run.staleness_sum
    with open(tpath + ".history.json") as f:
        assert json.load(f) == got.record
    assert jckpt.load_meta(tpath) == got.record
    assert sorted(os.listdir(os.path.dirname(tpath))) == sorted(
        os.listdir(os.path.dirname(jpath)))


def test_main_needs_a_mode(capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu"])
    assert exc.value.code == 2
    assert "need --preset or --arch" in capsys.readouterr().err


def test_main_runs_on_the_device_asked_for(tmp_path):
    argv = ["--arch", "mamba2-130m", "--smoke", "--rounds", "1", "--q", "1",
            "--inner-steps", "1", "--batch", "2", "--seq", "16",
            "--out", str(tmp_path)]
    got = train.main(argv + ["--device", "cpu"])
    assert all(x.device.type == "cpu" for x in tree_leaves(got.params))
    assert len(got.record["losses"]) == len(got.round_s) == 1
    assert np.isfinite(got.record["losses"]).all()
    with open(tmp_path / "train_mamba2-130m.json") as f:
        assert json.load(f) == got.record
    if not torch.cuda.is_available():
        # the default device is the card: no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="device='cuda'"):
            train.main(argv)
        with pytest.raises(RuntimeError, match="device='cuda'"):
            train.main(["--preset", "paper-mnist", "--rounds", "1",
                        "--out", str(tmp_path)])
