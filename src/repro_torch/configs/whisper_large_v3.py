"""whisper-large-v3 [audio] -- encoder-decoder with a stubbed frontend, as in
``src/repro/configs/whisper_large_v3.py``.

32 encoder and 32 decoder layers, d_model=1280, 20 heads of 64 (kv=20),
d_ff=5120, vocab=51866: 1,600,990,720 params in 25 leaves.  Source:
[arXiv:2212.04356] (Whisper).

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the model consumes precomputed frame embeddings (enc_len=1500,
30 s of audio) through a 32-layer bidirectional encoder; the 32-layer
decoder cross-attends to it.  long_500k skipped (full attention).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    is_encdec=True,
    enc_layers=32,
    enc_len=1500,
    train_microbatches=2,
    skip_shapes=("long_500k",),
    persafl_option="C",
    maml_mode="full",
)
