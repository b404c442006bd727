"""Server-apply kernels: ``apply_scaled``, ``apply_rows`` and
``apply_rows_q``."""
from repro_torch.kernels.fused_update.ops import (apply_delta_tree,  # noqa: F401
                                                  apply_rows_q_tree,
                                                  apply_rows_tree)
