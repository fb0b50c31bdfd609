"""whisper-small [arXiv:2212.04356]: 12L (enc) + 12L (dec) d=768 12H
d_ff=3072 vocab=51865 — enc-dec, conv frontend STUBBED (input_specs
provides 1500 precomputed frame embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865,
    norm_type="layernorm", mlp_gated=False, mlp_activation="gelu",
    enc_seq=1500, frontend="audio",
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, norm_type="layernorm", mlp_gated=False,
    mlp_activation="gelu", enc_seq=32, frontend="audio",
)
