"""Unified architecture configuration for all assigned model families."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    # dense-transformer variants
    qkv_bias: bool = False          # qwen1.5
    qk_norm: bool = False           # qwen3
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm | nonparam_ln
    parallel_block: bool = False    # command-r: attn and mlp in parallel
    mlp_activation: str = "silu"
    mlp_gated: bool = True
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # mixtral SWA
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0            # d_ff per expert (olmoe: 1024)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (mamba2 SSD)
    ssm_state: int = 0              # N
    ssm_head_dim: int = 64          # P
    ssm_expand: int = 2             # d_inner = expand * d_model
    ssm_chunk: int = 128            # SSD chunk length
    ssm_conv_width: int = 4
    ssm_n_groups: int = 1

    # hybrid (zamba2): shared transformer block every `attn_every` layers
    attn_every: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500             # audio frame positions (stub frontend)

    # modality frontend stub: none | audio | vision
    frontend: str = "none"

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # which attention implementation ("reference" | "pallas")
    attention_impl: str = "reference"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.n_heads))

    # ---- derived quantities -------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding/logits table rows padded to a 256 multiple so the
        vocab dim shards evenly (Megatron-style); labels never index the
        padding and logits are sliced back to ``vocab``."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> float:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            if self.family == "moe":
                ff = 3 * d * (self.expert_d_ff or self.d_ff) * self.n_experts
            else:
                ff = 3 * d * self.d_ff if self.mlp_gated else 2 * d * self.d_ff
            return emb + L * (attn + ff)
        if self.family == "ssm":
            di, N = self.d_inner, self.ssm_state
            per = d * (2 * di + 2 * self.ssm_n_groups * N + self.ssm_heads) + di * d
            return emb + L * per
        if self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            mamba = d * (2 * di + 2 * self.ssm_n_groups * N + self.ssm_heads) + di * d
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            ff = 3 * d * self.d_ff
            return emb + L * mamba + (attn + ff)  # shared block counted once
        if self.family == "encdec":
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            ff = 2 * d * self.d_ff  # whisper MLPs are ungated
            enc = self.n_enc_layers * (attn + ff)
            dec = L * (2 * attn + ff)  # self + cross attention
            return emb + enc + dec
        raise ValueError(self.family)

    def active_param_count(self) -> float:
        """Params touched per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ff = 3 * d * (self.expert_d_ff or self.d_ff) * self.top_k
        return emb + L * (attn + ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str               # train_4k | prefill_32k | decode_32k | long_500k
    kind: str               # train | prefill | decode
    seq_len: int
    global_batch: int
    # training-only knobs
    microbatches: int = 1   # gradient-accumulation steps inside train_step
    remat: bool = True


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def requires_subquadratic(shape: ShapeConfig) -> bool:
    return shape.name == "long_500k"


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; else (False, reason)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is a full-attention architecture (skip per spec)")
    return True, ""
