"""granite-moe-1b-a400m [moe] -- 32 experts, top-8, as in
``src/repro/configs/granite_moe_1b.py``.

24L d_model=1024 16H (GQA kv=8) d_ff=512 (expert) vocab=49155:
1,384,963,072 params in 13 leaves by the reference's init, 479 M of them
active per token.  Source: [hf:ibm-granite/granite-3.0-1b-a400m-base].
Pure full attention, so it skips ``long_500k``.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8, expert_d_ff=512),
    train_microbatches=1,
    skip_shapes=("long_500k",),
    persafl_option="C",
    maml_mode="fo",
)
