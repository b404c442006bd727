"""Placement of the port's tensors across ranks (``src/repro/sharding``)."""
from repro_torch.sharding.ctx import (activation_sharding,  # noqa: F401
                                      cohort_slice, shard_activation)
