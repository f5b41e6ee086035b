"""GRU building blocks: window reformat, one GRU layer, the GRU stack.

Port of ``cross_patient_speech_decoding_tpu/models/layers.py``
(``reformat_time_windows``, ``FusedGRU``, ``StackedRNN``). Parameters keep
the flax names and the (in, out) layout: ``wi`` (F, 3H), ``wh`` (H, 3H),
``bi`` and ``bh`` (3H,), gate order (r, z, n). Initialisation follows
flax, not torch's defaults: xavier-uniform ``wi``, orthogonal ``wh``, zero
biases.
"""

from __future__ import annotations

import torch
from torch import nn

from cross_patient_speech_decoding_tpu_torch.ops.gru import (
    gru_layer,
    gru_layer_windowed,
    reformat_time_windows,
)

__all__ = ["FusedGRU", "StackedRNN", "reformat_time_windows"]


class FusedGRU(nn.Module):
    """One GRU layer. (B, T, F) -> (outputs (B, T, H), h_last (B, H)).

    With ``window=(win, stride)`` the input is raw frames (B, T, C), read
    as overlapping windows of width win*C by the windowed op, which never
    builds the window stream. That data stream is cast to bf16 first, on
    every device, as the JAX package's kernel path does
    (models/layers.py:98-100), so the plain path and the kernel compute
    the same function.
    """

    def __init__(self, in_features: int, hidden: int, reverse: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        H = hidden
        self.wi = nn.Parameter(torch.empty(in_features, 3 * H))
        self.wh = nn.Parameter(torch.empty(H, 3 * H))
        self.bi = nn.Parameter(torch.zeros(3 * H))
        self.bh = nn.Parameter(torch.zeros(3 * H))
        # torch's xavier fans of a 2-D (F, 3H) tensor equal flax's
        nn.init.xavier_uniform_(self.wi, generator=generator)
        nn.init.orthogonal_(self.wh, generator=generator)

    def forward(self, x, h0=None, window: tuple | None = None):
        B = x.shape[0]
        H = self.hidden
        if h0 is None:
            h0 = torch.zeros((B, H), dtype=torch.float32, device=x.device)
        h0 = h0.float().contiguous()
        if window is not None:
            win, stride = window
            xt = x.to(torch.bfloat16).transpose(0, 1)  # (T, B, C) view
            hs = gru_layer_windowed(xt, h0, self.wi, self.bi, self.wh,
                                    self.bh, win, stride)
        else:
            hs = gru_layer(x.transpose(0, 1), h0, self.wi, self.bi,
                           self.wh, self.bh, self.reverse)
        h_last = hs[0] if self.reverse else hs[-1]
        return hs.transpose(0, 1), h_last


class StackedRNN(nn.Module):
    """Multi-layer unidirectional GRU stack (``nn.GRU(num_layers)``).

    Layer modules are ``fwd0``, ``fwd1``, ... as in the flax tree.
    Returns (out (B, T, H), last states (n_layers, B, H)). Inter-layer
    dropout applies in training mode only, with flax's semantics (keep
    with probability 1 - p, scale kept values by 1/(1 - p)); its mask is
    drawn from ``generator``, the counterpart of the JAX step's dropout
    key (torch's default generator when None).
    """

    def __init__(self, in_features: int, hidden: int, n_layers: int = 1,
                 dropout: float = 0.0, bidirectional: bool = False,
                 cell: str = "gru", generator: torch.Generator | None = None):
        super().__init__()
        if bidirectional:
            raise NotImplementedError(
                "bidirectional StackedRNN: waits for the fused bidirectional "
                "kernel (ROADMAP queue 2, item 6: _bifwd_kernel)"
            )
        if cell != "gru":
            raise NotImplementedError(
                "LSTM StackedRNN: waits for FusedLSTM (ROADMAP queue 1, "
                "item 7: offline NN family)"
            )
        self.hidden = hidden
        self.n_layers = n_layers
        self.dropout = dropout
        for layer in range(n_layers):
            F = in_features if layer == 0 else hidden
            self.add_module(f"fwd{layer}", FusedGRU(F, hidden,
                                                    generator=generator))

    def layer(self, i: int) -> FusedGRU:
        return getattr(self, f"fwd{i}")

    def forward(self, x, h0=None, window: tuple | None = None,
                generator: torch.Generator | None = None):
        out = x
        lasts = []
        for i in range(self.n_layers):
            h0_i = None if h0 is None else h0[i]
            out, last = self.layer(i)(
                out, h0_i, window=window if i == 0 else None
            )
            lasts.append(last)
            if self.training and self.dropout > 0 and i < self.n_layers - 1:
                out = _dropout(out, self.dropout, generator)
        return out, torch.stack(lasts)


def _dropout(x, rate: float, generator: torch.Generator | None):
    """flax ``nn.Dropout``: where(mask, x / keep, 0), mask ~
    Bernoulli(keep)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), device=x.device))
