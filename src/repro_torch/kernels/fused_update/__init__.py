"""Fused-update kernels: the local steps ``sgd_step``, ``prox_inner`` and
``prox_outer``, and the server applies ``apply_scaled``, ``apply_rows`` and
``apply_rows_q``."""
from repro_torch.kernels.fused_update.ops import (apply_delta_tree,  # noqa: F401
                                                  apply_rows_q_tree,
                                                  apply_rows_tree,
                                                  prox_inner_tree,
                                                  prox_outer_tree,
                                                  sgd_step_tree)
