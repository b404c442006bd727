"""Server-apply kernels: ``apply_scaled`` and ``apply_rows``."""
from repro_torch.kernels.fused_update.ops import (apply_delta_tree,  # noqa: F401
                                                  apply_rows_tree)
