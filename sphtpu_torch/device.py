"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda`` or an error. The CPU is used only
    when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sphtpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' (CLI: --device cpu) to run "
                "the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def require_on(dev: torch.device, *tensors) -> None:
    """Raise unless every tensor lies on a device of the resolved type."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type != dev.type:
            raise ValueError(
                f"tensor on {t.device} but the call runs on {dev}; move the "
                "state to that device or pass device= explicitly"
            )
