"""``make_train_step`` against the reference's at the hybrid family's
smoke config (zamba2-1.2b), Options A and C: ``check_train_step`` and its
tolerances are ``tests/test_torch_train_step.py``'s."""
import pytest

from test_torch_train_step import _one_torch_thread  # noqa: F401
from test_torch_train_step import check_train_step


@pytest.mark.parametrize("option", ["A", "C"])
def test_train_step_matches_reference(option):
    check_train_step("zamba2-1.2b", option)
