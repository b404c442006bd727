"""The Mamba2 SSD chunked scan: ``ssd_fwd`` (CUDA, ``kernel.py``) beside its
plain version ``ssd_ref`` (``ref.py``), picked by ``ops.ssd``."""
from repro_torch.kernels.ssd.ops import ssd  # noqa: F401
