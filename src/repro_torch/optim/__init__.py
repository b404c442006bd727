"""Minimal functional optimizers, as in ``src/repro/optim`` (the paper's
clients use plain SGD; Adam and momentum are there for beyond-paper
server-update variants)."""
from repro_torch.optim.optimizers import (Optimizer, adam,  # noqa: F401
                                          apply_updates, constant_lr,
                                          cosine_lr, momentum, sgd)
