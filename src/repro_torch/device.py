"""Device selection for the port's entry points.

Every entry point that creates tensors takes an explicit ``device``
defaulting to ``"cuda"``. On a host with no CUDA device that default
raises: the port never moves to the CPU unless the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA on a host
    without a CUDA device, or a device type the port does not run on."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but this host has no CUDA device; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
