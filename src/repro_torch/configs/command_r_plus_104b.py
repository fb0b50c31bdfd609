"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-*]: 64L d=12288 96H
(GQA kv=8) d_ff=33792 vocab=256000 — GQA, no-bias, parallel block,
non-RoPE-scaled LayerNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000,
    qkv_bias=False, norm_type="layernorm", parallel_block=True,
    rope_theta=75_000_000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab=256, norm_type="layernorm", parallel_block=True,
    tie_embeddings=True,
)
