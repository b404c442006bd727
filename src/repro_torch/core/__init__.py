"""PersA-FL core: the paper's contribution (Algorithms 1 & 2)."""
from repro_torch.core.types import PersAFLConfig, ServerState  # noqa: F401
from repro_torch.core.client import (client_update,  # noqa: F401
                                     split_batches_for_option)
from repro_torch.core.server import (init_server_state,  # noqa: F401
                                     apply_update, apply_buffered,
                                     apply_buffered_rows, admission_weights,
                                     staleness_stats)
from repro_torch.core.maml import maml_grad, personalize_maml  # noqa: F401
from repro_torch.core.moreau import (me_grad, personalize_me,  # noqa: F401
                                     solve_prox)
