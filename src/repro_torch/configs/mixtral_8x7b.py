"""mixtral-8x7b [arXiv:2401.04088]: 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, SWA 4096."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, expert_d_ff=14336,
    sliding_window=4096, norm_type="rmsnorm", rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, n_experts=4, top_k=2, expert_d_ff=128,
    sliding_window=32, norm_type="rmsnorm",
)
