"""``run_paper_preset`` with ``--preset paper-cifar`` (``CIFAR_CNN``, 3
classes per client) against the reference's at 3 rounds: ``check_preset``
and its tolerances are ``tests/test_torch_train.py``'s."""
from test_torch_train import _one_torch_thread, check_preset  # noqa: F401


def test_paper_cifar_preset_matches_reference(tmp_path, monkeypatch):
    got, _, _ = check_preset(tmp_path, monkeypatch, "paper-cifar", 3)
    assert got.record["preset"] == "paper-cifar"
