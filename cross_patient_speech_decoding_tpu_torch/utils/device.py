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
