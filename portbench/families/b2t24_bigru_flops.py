"""Operations and bytes of the bidirectional windowed GRU layer 0 of the
Brain-to-Text '24 baseline, from shapes alone: the least time of each
direction's forward call (``gru_wfwd``), from its span's attributes
(``wbidir_roofline.train``; each direction's backward with the frames'
gradient is ``b2t_gru_flops.frame_grad_least_s``).

As ``b2t_gru_flops.py`` counts them: each product at the rate a 3xTF32
product can reach on the H100, three TF32 passes for a float32 A operand
(495/3 TFLOP/s), two for a bf16 one (495/2: the products that read the
bf16 frames), and each byte of the work read or written once at 3.35 TB/s.
"""

from __future__ import annotations

from portbench.core.flops import gru_layer_work
from portbench.core.peaks import PEAK_BYTES
from portbench.families.b2t_gru_flops import BF16_A_FLOPS, F32_FLOPS


def wbidir_fwd_least_s(attrs: dict) -> float:
    """Least seconds of one windowed forward call (``T`` windows of ``B``
    rows, ``F`` = win C, ``H``, ``x_bytes`` the bf16 frames read,
    ``directions`` swept): each direction's projection x Wi (a bf16 A) and
    its recurrence h Wh; the frames read once, each direction's weights
    read and its states written once."""
    N, F, H = attrs["T"] * attrs["B"], attrs["F"], attrs["H"]
    dirs = attrs["directions"]
    bf16_a = dirs * 2 * N * 3 * H * F
    f32 = dirs * 2 * N * 3 * H * H
    nbytes = dirs * gru_layer_work(attrs["T"], attrs["B"], F, H)[1]
    nbytes += attrs["x_bytes"] - dirs * N * F * 4
    return max(f32 / F32_FLOPS + bf16_a / BF16_A_FLOPS, nbytes / PEAK_BYTES)
