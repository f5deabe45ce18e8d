"""The port's device rule: the CUDA card unless the caller names another."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the simulator "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)
