"""gemma2-2b [dense] -- local/global alternating attention, logit softcaps,
as in ``src/repro/configs/gemma2_2b.py``.

26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216 vocab=256000:
3,204,165,888 params in 14 leaves (``n_params``, the reference's formula,
gives 3,203,923,968).  Source: [arXiv:2408.00118] (Gemma 2).

Alternates sliding-window (4096) and global layers, layer 0 local;
attention logit softcap 50.0, final logit softcap 30.0; post-block RMSNorms
and the embedding scale sqrt(d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab=256000,
    head_dim=256,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    post_block_norm=True,
    train_microbatches=2,
    persafl_option="C",
    maml_mode="full",
)
