"""Architecture registry: --arch <id> resolves here."""
from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES, supports_shape

from repro_torch.configs import (
    qwen1_5_0_5b, qwen3_14b, command_r_plus_104b, olmo_1b, mamba2_780m,
    pixtral_12b, mixtral_8x7b, olmoe_1b_7b, zamba2_7b, whisper_small,
)

_MODULES = {
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "qwen3-14b": qwen3_14b,
    "command-r-plus-104b": command_r_plus_104b,
    "olmo-1b": olmo_1b,
    "mamba2-780m": mamba2_780m,
    "pixtral-12b": pixtral_12b,
    "mixtral-8x7b": mixtral_8x7b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "zamba2-7b": zamba2_7b,
    "whisper-small": whisper_small,
}

ARCHS = {name: mod.CONFIG for name, mod in _MODULES.items()}
SMOKE_ARCHS = {name: mod.SMOKE for name, mod in _MODULES.items()}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_ARCHS if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(table)}")
    return table[arch]
