"""internvl2-76b [vlm] -- an InternLM2-style 70B+ language model behind a
stubbed vision front end, as in ``src/repro/configs/internvl2_76b.py``.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Source: [arXiv:2404.16821] (InternVL 1.5/2 series).

The vision encoder is a stub, as in the reference: a batch carries
precomputed patch embeddings ``visual`` (n_visual_tokens positions), which
``vis_proj`` maps and prepends to the text embeddings; the decoder backbone
is implemented.  Pure full attention, so it skips ``long_500k``.  About
70.6 B params: 282 GB in f32, more than one card holds, so the port runs it
at ``reduce_for_smoke`` only until the multi-device paths (ROADMAP.md
Queue 1, multi-device paths).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    n_visual_tokens=1024,
    train_microbatches=16,
    skip_shapes=("long_500k",),
    persafl_option="C",
    maml_mode="fo",
)
