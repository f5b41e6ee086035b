"""Realtime CTC RNN, the streaming phoneme decoder (flagship model).

Port of ``cross_patient_speech_decoding_tpu/models/realtime_rnn.py``:
sliding windows (win 14, stride 4) over the raw frames, a stacked GRU with
a trainable initial state, and a per-window dense CTC head whose bias
starts at -2 everywhere and +2 on blank. Parameter names and layouts are
the flax tree's: ``h0`` (n_layers * n_dir, 1, H),
``rnn.fwd{l}.{wi,wh,bi,bh}`` (and ``rnn.bwd{l}`` when bidirectional),
``head.kernel`` (n_dir * H, V) and ``head.bias`` (V,).

The bidirectional model (the reference's ``bidirectional`` hparam) is an
offline model: its stack materialises the windows once and runs each layer
through the fused bidirectional op, so on the card a train step launches
``gru_bifwd`` and twice ``gru_bwd`` a layer and no windowed kernel. It
cannot stream.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cross_patient_speech_decoding_tpu_torch.models.layers import (
    Dense,
    StackedRNN,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)


def adjusted_input_lengths(input_lengths, win: int, stride: int):
    """Window-adjusted valid frame counts (reference
    realtime_nn_model.py:214)."""
    return torch.div(input_lengths - win, stride,
                     rounding_mode="floor") + 1


class RealtimeRNN(nn.Module):
    """Windowed stacked-GRU CTC model.

    ``in_channels`` is the channel count C of the raw (B, T, C) frames;
    layer 0 reads win_size*C features per window. Weights are drawn from
    ``seed`` with a CPU ``torch.Generator``, then moved to ``device``
    (default: the first CUDA card; raises without one).
    """

    def __init__(self, in_channels: int, hidden: int, n_layers: int,
                 n_classes: int, dropout: float = 0.3, win_size: int = 14,
                 stride: int = 4, bidirectional: bool = False,
                 blank: int = 0, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_channels = in_channels
        self.hidden = hidden
        self.n_layers = n_layers
        self.n_classes = n_classes
        self.win_size = win_size
        self.stride = stride
        self.bidirectional = bidirectional
        self.blank = blank
        gen = torch.Generator().manual_seed(seed)

        # flax xavier_uniform on (n_layers * n_dir, 1, H): receptive field
        # n_layers * n_dir, fan_in that, fan_out that times H
        n_dir = 2 if bidirectional else 1
        rows = n_layers * n_dir
        self.h0 = nn.Parameter(torch.empty(rows, 1, hidden))
        lim = math.sqrt(6.0 / (rows * (1 + hidden)))
        nn.init.uniform_(self.h0, -lim, lim, generator=gen)
        self.rnn = StackedRNN(win_size * in_channels, hidden, n_layers,
                              dropout=dropout, bidirectional=bidirectional,
                              generator=gen)
        self.head = Dense(n_dir * hidden, n_classes, generator=gen)
        with torch.no_grad():
            self.head.bias.fill_(-2.0)  # suppress phonemes early
            self.head.bias[blank] = 2.0  # encourage blank early
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.h0.device

    def forward(self, x, generator: torch.Generator | None = None):
        """x (B, T, C) -> logits (B, n_win, n_classes). ``generator`` draws
        the inter-layer dropout masks in training mode."""
        h0 = self.initial_hidden(x.shape[0])
        out, _ = self.rnn(x, h0, window=(self.win_size, self.stride),
                          generator=generator)
        return self.head(out)

    def initial_hidden(self, batch: int = 1):
        """Trainable initial state broadcast to (n_layers * n_dir, batch,
        H); its gradient sums over the batch, as JAX's broadcast does."""
        return self.h0.expand(self.h0.shape[0], batch, self.hidden)

    def single_step(self, window, h):
        """One streaming step. window (B, win*C), h (n_layers, B, H) ->
        (logits (B, n_classes), new_h (n_layers, B, H)). Unidirectional
        models only: a bidirectional one raises ``ValueError``.

        The window goes to the GRU in float32, as in the JAX package; the
        offline forward rounds its layer-0 frames to bf16, so the two agree
        to bf16 input tolerance.
        """
        if self.bidirectional:
            raise ValueError("single_step needs a unidirectional model (a "
                             "bidirectional GRU cannot run causally)")
        out, new_h = self.rnn(window[:, None, :], h)
        return self.head(out[:, 0, :]), new_h
