"""The chip's published peaks and the least time of a piece of work.

NVIDIA H100 SXM data sheet, dense: 495 TFLOP/s TF32 on the tensor cores,
3.35 TB/s of HBM3, at the full 700 W power limit. Both configurations
compute in float32; TF32 is the highest rate at which the chip multiplies
float32 inputs, so every share is of that peak, whatever split of a
float32 product into TF32 products an implementation chooses.
"""

from __future__ import annotations

import subprocess

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of the compute bound and the memory bound."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def card_power() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not readable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi: {out.stderr.strip()}"
