"""qwen3-14b [hf:Qwen/Qwen3-*]: 40L d=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA.  head_dim=128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936,
    qk_norm=True, norm_type="rmsnorm", rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-14b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, head_dim=16,
    d_ff=192, vocab=256, qk_norm=True, norm_type="rmsnorm",
)
