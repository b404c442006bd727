"""``run_arch --smoke`` against the reference's at granite-moe-1b-a400m:
``check_run_arch`` and its tolerances are
``tests/test_torch_train_arch.py``'s."""
from test_torch_train import _one_torch_thread  # noqa: F401
from test_torch_train_arch import check_run_arch


def test_run_arch_smoke_matches_reference(tmp_path, monkeypatch):
    check_run_arch("granite-moe-1b-a400m", tmp_path, monkeypatch)
