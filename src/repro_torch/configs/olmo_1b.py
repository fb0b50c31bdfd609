"""olmo-1b [arXiv:2402.00838]: 16L d=2048 16H (GQA kv=16) d_ff=8192
vocab=50304 — non-parametric LayerNorm, untied ff (SwiGLU d_ff=8192
interpreted as the MLP hidden)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304,
    norm_type="nonparam_ln", mlp_gated=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-1b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=256, norm_type="nonparam_ln", tie_embeddings=True,
)
