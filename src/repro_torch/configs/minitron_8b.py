"""minitron-8b [dense] -- pruned Nemotron, as in
``src/repro/configs/minitron_8b.py``.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Source: [arXiv:2407.14679] (Minitron: compact LMs via pruning and
distillation).  Pure full attention, so it skips ``long_500k``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="minitron-8b",
    family="dense",
    source="arXiv:2407.14679",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    train_microbatches=4,
    skip_shapes=("long_500k",),
    persafl_option="C",
    maml_mode="full",
)
