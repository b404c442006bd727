"""The multi-device entry points on one spawned rank
(``tests/torch_ranks.py``, body ``one_rank``; no process group in the
pytest process).

* ``launch/serve.py --smoke --personalize --model-axis 1 --coordinator
  127.0.0.1:<free port> --num-processes 1 --process-id 0`` serves the
  sharded server on the 1x1 ("cohort", "model") mesh with the same heads
  and tokens, bit for bit, as the same command without the flags (on the
  CPU both engines map their rows one at a time), no host copy, and no
  process group left behind.
* ``make_cohort_train_step`` on ``make_host_mesh()`` equals
  ``make_train_step`` bit for bit (the reference's
  ``test_cohort_step_equals_pjit_on_one_device``); ``make_host_mesh`` is
  the memoized 1x1 ("data", "model") mesh, and the production meshes
  refuse a world of another size.
"""
import numpy as np
import pytest

from torch_ranks import spawn


@pytest.fixture(scope="module")
def rank(tmp_path_factory):
    return spawn("one_rank", 1, tmp_path_factory.mktemp("one_rank"),
                 timeout_s=120)[0]


def test_serve_mesh_flags_serve_the_same_heads_and_tokens(rank):
    plain, mesh = rank["plain"], rank["mesh"]
    np.testing.assert_array_equal(mesh["tokens"], plain["tokens"])
    assert len(mesh["heads"]) == len(plain["heads"])
    for a, b in zip(mesh["heads"], plain["heads"]):
        np.testing.assert_array_equal(a, b)
    assert mesh["cohort_calls"] == plain["cohort_calls"] == 1


def test_serve_mesh_flags_run_the_sharded_server(rank):
    mesh, plain = rank["mesh"], rank["plain"]
    assert mesh["impl"] == "shard_map" and plain["impl"] == "map"
    assert mesh["record"]["model_axis"] == 1
    assert plain["record"]["model_axis"] is None
    assert mesh["record"]["host_materializations"] == 0


def test_serve_destroys_the_group_it_started(rank):
    assert not rank["group_left"]


def test_cohort_step_equals_train_step_on_one_rank(rank):
    assert rank["step_equal"] and rank["metrics_equal"]
    assert rank["step_moved"]


def test_launch_meshes(rank):
    assert rank["host_mesh"] == (("data", "model"), (1, 1), True)
    assert rank["production_False"] == (
        "mesh (16, 16) over axes ('data', 'model') needs 256 ranks, the "
        "process group has 1")
    assert "needs 512 ranks" in rank["production_True"]
