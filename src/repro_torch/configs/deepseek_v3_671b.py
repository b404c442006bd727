"""deepseek-v3-671b [moe] -- MLA, 1 shared + 256 routed top-8 experts and
MTP, as in ``src/repro/configs/deepseek_v3_671b.py``.

61L d_model=7168 128H (GQA kv=128) d_ff=2048 (expert) vocab=129280.
Source: [arXiv:2412.19437] (DeepSeek-V3).

MLA (multi-head latent attention): q_lora 1536, kv_lora 512, nope 128 /
rope 64 head dims, v 128.  The first 3 layers are dense (d_ff 18432).  MTP:
one extra multi-token-prediction block, in the training loss only.  Pure
full attention, so it skips ``long_500k``.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, expert_d_ff=2048,
                  n_shared_experts=1, shared_d_ff=2048,
                  first_k_dense=3, dense_d_ff=18432),
    use_mtp=True,
    train_microbatches=16,
    skip_shapes=("long_500k",),
    persafl_option="C",
    maml_mode="fo",
)
