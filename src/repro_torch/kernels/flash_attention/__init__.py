"""Forward flash attention: ``flash_attention_fwd`` (CUDA, ``kernel.py``)
beside its plain version ``attention_ref`` (``ref.py``), picked by
``ops.flash_attention``."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
