"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d=1024 16H (GQA kv=16)
d_ff=2816 vocab=151936 — QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936,
    qkv_bias=True, norm_type="rmsnorm", rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=176, vocab=256, qkv_bias=True, norm_type="rmsnorm",
    tie_embeddings=True,
)
