"""codeqwen1.5-7b [dense] -- the Qwen1.5 architecture, as in
``src/repro/configs/codeqwen1p5_7b.py``.

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416, QKV bias, rope
theta 1e6.  Source: [hf:Qwen/CodeQwen1.5-7B].  Pure full attention, so it
skips ``long_500k``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="codeqwen1.5-7b",
    family="dense",
    source="hf:Qwen/CodeQwen1.5-7B",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    train_microbatches=4,
    skip_shapes=("long_500k",),
    persafl_option="C",
    maml_mode="full",
)
