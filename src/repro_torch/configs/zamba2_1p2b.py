"""zamba2-1.2b [hybrid] -- Mamba2 backbone + one shared attention block, as
in ``src/repro/configs/zamba2_1p2b.py``.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64:
1,183,058,816 params in 21 leaves (``n_params``, the reference's formula,
gives 1,182,649,344).  Source: [arXiv:2411.15242] (Zamba2 technical report).

Hybrid: Mamba2 layers, with a single *shared* transformer (attn+MLP) block
applied every ``attn_every`` layers on concat(hidden, original embedding).
The shared block's attention uses a sliding window of ``sliding_window``
keys, in training, prefill and decode alike.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk=128),
    attn_every=6,
    sliding_window=4096,
    train_microbatches=2,
    persafl_option="C",
    maml_mode="hf",  # HVP through the scan avoided (paper Eq. D1)
)
