"""mamba2-130m [ssm] -- SSD (state-space duality), attention-free, as in
``src/repro/configs/mamba2_130m.py``.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128: 167,598,528 params in 12
leaves.  Source: [arXiv:2405.21060] (Mamba2 / SSD).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=128),
    train_microbatches=1,
    persafl_option="C",
    maml_mode="hf",  # HVP through the scan avoided (paper Eq. D1)
)
