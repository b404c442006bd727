"""``client_update`` under Option B with ``maml_mode="full"`` at the zamba2
hybrid's smoke config, every Mamba2 block through ``SSDScan``'s jvp rule:
``check_option_b_full`` and its tolerances are
``tests/test_torch_train_step_maml_ssm.py``'s."""
from test_torch_train_step import _one_torch_thread  # noqa: F401
from test_torch_train_step_maml_ssm import check_option_b_full, kernel_scan  # noqa: F401,E501


def test_option_b_full_matches_reference(kernel_scan):  # noqa: F811
    check_option_b_full("zamba2-1.2b")
