"""qwen1.5-110b [dense] -- QKV bias (Qwen1.5 family), as in
``src/repro/configs/qwen1p5_110b.py``.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, rope theta 1e6.
Source: [hf:Qwen/Qwen1.5-0.5B] (the family card, scaled to 110B).  Pure
full attention, so it skips ``long_500k``.  About 111 B params: 445 GB in
f32, more than one card holds, so the port runs it at ``reduce_for_smoke``
only until the multi-device paths (ROADMAP.md Queue 1, multi-device paths).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1.5-110b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    train_microbatches=16,
    skip_shapes=("long_500k",),
    persafl_option="C",
    maml_mode="fo",
)
