"""zamba2-7b [arXiv:2411.15242]: 81L d=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
every 6 layers (13 invocations + 3 tail mamba layers)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    attn_every=6, norm_type="rmsnorm",
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke", family="hybrid",
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    attn_every=3, norm_type="rmsnorm",
)
