"""PersA-FL core: the paper's contribution (Algorithms 1 & 2)."""
from repro_torch.core.types import PersAFLConfig, ServerState  # noqa: F401
from repro_torch.core.client import (client_update,  # noqa: F401
                                     split_batches_for_option)
from repro_torch.core.server import (init_server_state,  # noqa: F401
                                     apply_update, apply_buffered,
                                     apply_buffered_rows,
                                     apply_admitted_rows, admission_weights,
                                     robust_admission_weights,
                                     robust_flush_weights, bank_row_norms,
                                     mask_rows, scale_rows, staleness_stats)
from repro_torch.core.maml import maml_grad, personalize_maml  # noqa: F401
from repro_torch.core.moreau import (me_grad, personalize_me,  # noqa: F401
                                     solve_prox)
from repro_torch.core.subset import (SubsetSpec, leaf_paths,  # noqa: F401
                                     merge_subset, subset_like, row_nbytes,
                                     tree_nbytes)
from repro_torch.core.quant import (QuantStack, QuantTree,  # noqa: F401
                                    QuantizedBank, QuantizedHeads,
                                    quantize_stack, dequantize_stack,
                                    quantize_tree, dequantize_tree,
                                    ef_quantize_stack, fp32_row_nbytes)
from repro_torch.checkpoint.store import (save_pytree,  # noqa: F401
                                          load_pytree, load_meta,
                                          save_server_state,
                                          load_server_state)
