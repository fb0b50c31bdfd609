"""Device resolution for every entry point of the port.

``device=None`` means the card: ``"cuda"``.  Without CUDA that raises;
the CPU runs only when a caller asks for it by name, as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run it on the CPU")
    return dev
