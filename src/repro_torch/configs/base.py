"""Architecture configuration, as in ``src/repro/configs/base.py``.

Every LLM architecture is described by an :class:`ArchConfig`, a frozen
dataclass consumed by the model builders in :mod:`repro_torch.models` and the
launch layer, and selectable by id through
:func:`repro_torch.configs.get_config` (``--arch <id>`` in the launchers).
The fields are the reference's, one for one; ``activation_dtype`` is a
``torch.dtype``.

Input shapes (the reference's public pool):

===========  ==========  ============  ================
name         seq_len     global_batch  kind
===========  ==========  ============  ================
train_4k     4,096       256           training
prefill_32k  32,768      32            inference-prefill
decode_32k   32,768      128           inference-decode
long_500k    524,288     1             long-context-decode
===========  ==========  ============  ================
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> InputShape:
    for s in INPUT_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown input shape {name!r}; have "
                   f"{[s.name for s in INPUT_SHAPES]}")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001  # load-balance loss weight
    first_k_dense: int = 0            # leading dense layers (deepseek-v3)
    dense_d_ff: int = 0               # ffn width of those dense layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD (arXiv:2405.21060)."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    n_groups: int = 1  # B/C groups


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    source: str                  # citation for the config
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention flavour
    qkv_bias: bool = False
    attn_softcap: float = 0.0    # 0 disables (gemma2: 50.0)
    final_softcap: float = 0.0   # gemma2: 30.0
    sliding_window: int = 0      # 0 disables
    local_global_period: int = 0  # gemma2: 2 -> alternate local/global
    rope_theta: float = 10_000.0
    post_block_norm: bool = False  # gemma2 post-norms

    # family extensions
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0          # hybrid (zamba2): shared attn block period
    use_mtp: bool = False        # deepseek multi-token prediction head

    # encoder-decoder (whisper)
    is_encdec: bool = False
    enc_layers: int = 0
    enc_len: int = 0             # fixed encoder length (1500 = 30s audio)

    # multimodal stub frontend
    n_visual_tokens: int = 0     # vlm: stubbed patch-embedding count

    # runtime
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save matmul outputs)
    train_microbatches: int = 1
    skip_shapes: Tuple[str, ...] = ()

    # PersA-FL defaults for this arch (see repro_torch.core)
    persafl_option: str = "C"          # A | B | C
    maml_mode: str = "hf"              # full | fo | hf (Option B HVP)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def activation_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{self.arch_id}: dtype {self.dtype!r} is not "
                             f"a torch dtype")
        return dt

    @property
    def n_params(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab * d * 2  # in + out embedding (untied)
        per_layer = 0
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            # in_proj (z,x,B,C,dt) + out_proj + conv
            per_layer += d * (2 * d_in + 2 * s.n_groups * s.state_dim + nh)
            per_layer += d_in * d
            per_layer += (d_in + 2 * s.n_groups * s.state_dim) * s.conv_width
        if self.family not in ("ssm",):  # attention present
            if self.mla is not None:
                m = self.mla
                per_layer += d * m.q_lora_rank + m.q_lora_rank * n_q * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                per_layer += m.kv_lora_rank * n_q * (m.qk_nope_head_dim
                                                     + m.v_head_dim)
                per_layer += n_q * m.v_head_dim * d
            elif self.attn_every:
                pass  # hybrid: shared attn counted once below
            else:
                per_layer += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
        if self.moe is not None:
            mo = self.moe
            moe_layers = L - mo.first_k_dense
            per_layer_moe = mo.n_experts * 3 * d * mo.expert_d_ff \
                + d * mo.n_experts
            per_layer_moe += mo.n_shared_experts * 3 * d * mo.shared_d_ff
            dense = mo.first_k_dense * 3 * d * mo.dense_d_ff
            total = emb + L * per_layer + moe_layers * per_layer_moe + dense
        elif self.family == "ssm":
            total = emb + L * per_layer
        elif self.attn_every:
            # zamba2: shared attn+mlp block, params counted once
            shared = 2 * d * hd * (n_q + 2 * n_kv) + n_q * hd * d \
                + 3 * d * self.d_ff
            total = emb + L * per_layer + shared
        else:
            per_layer += 3 * d * self.d_ff  # gate/up/down
            total = emb + L * per_layer
        if self.is_encdec:
            # encoder self-attn + ffn, decoder cross-attn
            enc = self.enc_layers * (d * hd * (n_q + 2 * n_kv) + n_q * hd * d
                                     + 2 * d * self.d_ff)
            cross = L * (d * hd * (n_q + 2 * n_kv) + n_q * hd * d)
            total += enc + cross
        return int(total)

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.n_params
        mo = self.moe
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model \
            * mo.expert_d_ff
        return int(self.n_params - (self.n_layers - mo.first_k_dense)
                   * inactive)

    def supports(self, shape_name: str) -> bool:
        return shape_name not in self.skip_shapes


# ---------------------------------------------------------------------------
# reduced variants for CPU smoke tests (2 layers, d_model<=512, <=4 experts)
# ---------------------------------------------------------------------------

def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Shrink a full config to a CPU-runnable variant of the same family."""
    d = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    ratio = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    n_kv = max(1, n_heads // ratio)
    hd = 32
    repl = dict(
        n_layers=2,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 4 * d) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        dtype="float32",
        remat=False,
        train_microbatches=1,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window
        else 0,
    )
    if cfg.moe is not None:
        repl["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            top_k=2,
            expert_d_ff=2 * d,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            shared_d_ff=2 * d if cfg.moe.n_shared_experts else 0,
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            dense_d_ff=2 * d if cfg.moe.first_k_dense else 0,
        )
    if cfg.mla is not None:
        repl["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                qk_nope_head_dim=hd, qk_rope_head_dim=16,
                                v_head_dim=hd)
    if cfg.ssm is not None:
        repl["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32,
                                          chunk=16)
    if cfg.attn_every:
        repl["attn_every"] = 2
    if cfg.is_encdec:
        repl["enc_layers"] = 2
        repl["enc_len"] = 16
    if cfg.n_visual_tokens:
        repl["n_visual_tokens"] = 8
    return dataclasses.replace(cfg, **repl)
