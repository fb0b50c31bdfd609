"""The port's Hopper kernels: one wrapper module per TPU kernel it
replaces (each with an integer ``launches`` count; flash attention and
the SSD scan choose between two CUDA kernels by dtype and also count
each), their plain
PyTorch versions in ``ref``, the model-layout adapters in ``ops`` and
the build in ``_build``."""

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


def variant_counts() -> Dict[str, int]:
    """Launches per kernel variant of the wrappers that choose between
    kernels, as ``"<wrapper>.<variant>"`` (``flash_attention.tc``,
    ``flash_attention.f32``, ``ssd_scan.tc``, ``ssd_scan.f32``); they sum
    to the wrapper's count."""
    return {f"{name}.{c[len('launches_'):]}": getattr(mod, c)
            for name, mod in WRAPPERS.items()
            for c in getattr(mod, "COUNTERS", ())[1:]}


def reset_launch_counts() -> None:
    for mod in WRAPPERS.values():
        for c in getattr(mod, "COUNTERS", ("launches",)):
            setattr(mod, c, 0)
