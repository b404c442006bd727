"""The tests of ``test_torch_moe_lm.py`` on deepseek-v3-671b at
``reduce_for_smoke`` (1 dense-prefix layer, then 1 MoE layer of 4 experts,
top-2, with one shared expert; MLA with q_lora 64, kv_lora 32, nope 32 /
rope 16 / v 32, 4 heads; the MTP block), f32: the dense prefix as a list of
unstacked layers through ``params_from_jax``, ``params_to_numpy`` and both
packages' checkpoints; hidden, logits, the loss with the aux and 0.1 x MTP
losses and its gradient; prefill; absorbed-MLA decode against the reference
and against prefill.  Inputs and tolerances are that file's; this file
gives them deepseek's ``smoke`` fixture.
"""
import pytest

# collected here, on deepseek's fixture below
from test_torch_moe_lm import (  # noqa: F401
    _one_torch_thread, make_smoke, test_attention_path_by_arch,
    test_decode_steps_match_reference,
    test_hidden_logits_and_aux_match_reference,
    test_loss_and_gradient_match_reference,
    test_mtp_loss_matches_reference_and_moves_the_loss,
    test_param_tree_structure,
    test_params_round_trip_through_numpy_and_checkpoints,
    test_prefill_and_decode_compute_the_same_model,
    test_prefill_logits_match_reference,
    test_reference_checkpoint_loads_with_equal_logits)


@pytest.fixture(scope="module")
def smoke():
    return make_smoke("deepseek-v3-671b")
