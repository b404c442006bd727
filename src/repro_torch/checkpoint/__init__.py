"""npz checkpoints in the JAX package's layout (either package loads what
the other wrote)."""
from repro_torch.checkpoint.store import (save_pytree,  # noqa: F401
                                          load_pytree, load_meta,
                                          save_server_state,
                                          load_server_state)
