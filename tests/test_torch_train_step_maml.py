"""``make_train_step`` against the reference's under Option B with
``maml_mode="full"`` at the dense gemma2-2b's smoke config: the exact
Hessian-vector product, ``torch.func.jvp`` of ``torch.func.grad``, runs
forward mode through ``FlashAttention``'s jvp rule (the jvp of the plain
attention) and through its plain backward.  ``check_train_step`` and its
tolerances are ``tests/test_torch_train_step.py``'s."""
import pytest
import torch

from repro_torch import configs
from repro_torch.core import PersAFLConfig, client_update
from repro_torch.models import api
from test_torch_train_step import _one_torch_thread  # noqa: F401
from test_torch_train_step import check_train_step


def test_option_b_full_matches_reference():
    check_train_step("gemma2-2b", "B", "full")


def test_option_b_full_runs_through_flash_attention():
    """The HVP reaches ``FlashAttention`` (not a plain ``sdpa``): without
    its jvp rule forward mode raises."""
    cfg = configs.reduce_for_smoke(configs.get_config("gemma2-2b"))
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 1, 16), dtype=torch.int32)
    b = {"tokens": toks, "labels": toks}
    pcfg = PersAFLConfig(option="B", q_local=1, maml_mode="full")
    from repro_torch.models import attention
    real = attention.FlashAttention.jvp
    try:
        del attention.FlashAttention.jvp
        with pytest.raises(NotImplementedError, match="jvp"):
            client_update(pcfg, lambda p, bb: api.loss_fn(cfg, p, bb),
                          params, {"d": b, "dp": b, "dpp": b})
    finally:
        attention.FlashAttention.jvp = real
