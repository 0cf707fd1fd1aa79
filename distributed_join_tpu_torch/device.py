"""Device resolution for the entry points that create tensors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one the call raises rather than
    running on the CPU behind the caller's back; the CPU is used only
    when asked for by name (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
