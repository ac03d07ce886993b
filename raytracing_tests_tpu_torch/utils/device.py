"""Device selection for the entry points.

``device=None`` means the GPU.  Nothing here picks the CPU by itself: the CPU
runs only when a caller names it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); else ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; this entry point runs on the GPU "
                "unless device='cpu' is passed explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    return device
