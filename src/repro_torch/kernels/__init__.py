"""The port's Hopper kernels: one wrapper module per CUDA kernel (each
with an integer ``launches`` count), their plain PyTorch versions in
``ref``, the model-layout adapters in ``ops`` and the build in
``_build``."""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import (flash_attention, paged_attention, rmsnorm,
                                 ssd_scan)

WRAPPERS = {"paged_attention": paged_attention,
            "flash_attention": flash_attention,
            "rmsnorm": rmsnorm,
            "ssd_scan": ssd_scan}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in WRAPPERS.values():
        mod.launches = 0
