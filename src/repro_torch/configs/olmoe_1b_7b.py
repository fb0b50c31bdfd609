"""olmoe-1b-7b [arXiv:2409.02060]: 16L d=2048 16H (GQA kv=16) d_ff=1024
(per expert) vocab=50304, MoE 64 experts top-8."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, expert_d_ff=1024,
    norm_type="rmsnorm",
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=256, n_experts=8, top_k=2, expert_d_ff=32,
    norm_type="rmsnorm",
)
