"""Operations and bytes of the brain-to-text decoder's work, from shapes
alone: the least time of a ``gru_wbwd`` call that forms the frames'
gradient (``frame_grad_roofline.train``), from its span's attributes.

The least time counts each product at the rate a 3xTF32 product can reach
on the H100: three TF32 passes for a float32 A operand (495/3 TFLOP/s),
two for a bf16 one (the windows' half of the gate recompute and dWi read
the bf16 frames: 495/2), and each byte of the work read or written once
at 3.35 TB/s.
"""

from __future__ import annotations

from portbench.core.flops import gru_layer_work
from portbench.core.peaks import PEAK_BYTES, PEAK_FLOPS

F32_FLOPS = PEAK_FLOPS / 3
BF16_A_FLOPS = PEAK_FLOPS / 2


def n_windows(T: int, win: int, stride: int) -> int:
    return (T - win) // stride + 1


def frame_grad_least_s(attrs: dict) -> float:
    """Least seconds of one ``gru_wbwd`` call with the frames' gradient,
    from its span's attributes (``T`` windows of ``B`` rows, ``F`` = win C,
    ``H``, ``x_bytes`` the bf16 frames it read): the gate recompute, the
    per-step dh product, dx = dgi Wi^T, its fold onto the frames (one add
    a window element), dWi and dWh; the frames read once, their float32
    gradient written once."""
    N, F, H = attrs["T"] * attrs["B"], attrs["F"], attrs["H"]
    bf16_a = 2 * N * 3 * H * F * 2  # x Wi of the recompute, dWi = x^T dgi
    f32 = 2 * N * 3 * H * (H + H + F + H) + N * F
    nbytes = gru_layer_work(attrs["T"], attrs["B"], F, H, need_dx=True)[3]
    nbytes += 3 * attrs["x_bytes"] - 2 * N * F * 4
    return max(f32 / F32_FLOPS + bf16_a / BF16_A_FLOPS, nbytes / PEAK_BYTES)
