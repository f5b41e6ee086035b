"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the first CUDA card, and raises when there is none: the
    port never goes on quietly on the CPU. The CPU is used only when the
    caller asks for it (``device="cpu"``), as the tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is "
                           "not available")
    return dev


def same_device(*tensors) -> None:
    """Raise ``ValueError`` unless every tensor given (None skipped) lies on
    one device: the alignment ops run on their inputs' device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) > 1:
        raise ValueError(f"inputs on mixed devices: {sorted(map(str, devices))}")
