"""Device resolution and fencing for the PyTorch port.

Every public function of the port takes an explicit ``device``. A CUDA
device that is not there is an error: nothing on the main path carries
on on the CPU in its place.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device`` (a device or a string); raises
    RuntimeError for a CUDA device when CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev


def synchronize(device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
