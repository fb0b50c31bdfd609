"""mamba2-780m [arXiv:2405.21060]: 48L d=1536 attn-free, ssm_state=128,
SSD (state-space duality).  d_inner = 2*d = 3072, headdim 64 -> 48 heads."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, head_dim=1,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    norm_type="rmsnorm", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=256, head_dim=1,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    norm_type="rmsnorm", tie_embeddings=True,
)
