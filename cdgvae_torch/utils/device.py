"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    The port runs on the GPU unless the caller asks for the CPU: a CUDA
    device without a GPU raises ``SystemExit`` instead of quietly running
    on the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"device {device} requested but no CUDA device is available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"unsupported device {device}: use cuda or cpu")
    return device
