"""Synthetic federated datasets and token streams (numpy, bit-identical to
the reference)."""
from repro_torch.data.federated import (ClientData,  # noqa: F401
                                        eval_batch, make_federated_dataset,
                                        sample_batches,
                                        synthetic_token_batch)
