"""pixtral-12b [hf:mistralai/Pixtral-12B-2409]: 40L d=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072 — mistral-nemo decoder backbone; pixtral-ViT
frontend STUBBED (input_specs provides patch embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072,
    norm_type="rmsnorm", rope_theta=1_000_000_000.0,
    frontend="vision",
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, norm_type="rmsnorm", frontend="vision",
)
