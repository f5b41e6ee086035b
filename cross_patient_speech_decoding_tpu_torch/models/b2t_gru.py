"""Brain-to-text GRU decoders: Card et al., "An Accurate and Rapidly
Calibrating Speech Neuroprosthesis", NEJM 2024 (``GRUDecoder`` of
github.com/Neuroprosthetics-Lab/nejm-brain-to-text,
``model_training/rnn_model.py``), the baseline of the Brain-to-Text '25
benchmark, whose window reformat ``RealtimeRNN`` inherits; and, with
``bidirectional``, ``learned_h0=False``, ``smooth_sigma`` and no input
dropout, its ancestor, the Brain-to-Text '24 baseline (Willett et al., "A
high-performance speech neuroprosthesis", Nature 2023; ``GRUDecoder`` of
github.com/cffan/neural_seq_decoder, ``src/neural_decoder/model.py``).

    x'_b = dropout(softsign(x_b W_{d(b)} + b_{d(b)}))      day layer
    w_{b,k} = [x'_{b,4k}, ..., x'_{b,4k+13}]                 patches
    h = GRU_L(w; h0)                                         one h0, all layers
    logits = h W_o + b_o

The '24 baseline smooths each channel over time first (``smooth_time``,
20 taps of a Gaussian of sigma 2), reads 32-frame patches every 4 through
a bidirectional stack from a zero state, and has no input dropout:

    s_b = x_b * k;  y_b = softsign(s_b W_{d(b)} + b_{d(b)})
    h = BiGRU_L([y_{b,4k}, ..., y_{b,4k+31}]; 0);  logits = h W_o + b_o

Each recording day (session) has its own affine map of the 512 features
(256 electrodes x threshold crossings and spike-band power), applied to
the rows of that day (:class:`~.layers.DayAffine`); the patches are the
windowed layer-0 GRU of ``RealtimeRNN``, whose frames here train, so its
backward forms their gradient (bidirectional: both directions'). Parameter
names: ``day.w`` (n_days, C, C), ``day.b`` (n_days, C), ``h0`` (1, 1, H)
where learned, ``rnn.fwd{l}.{wi,wh,bi,bh}`` and, bidirectional,
``rnn.bwd{l}.*``, ``head.kernel`` (n_dir H, V), ``head.bias`` (V,); the
smoothing kernel is the buffer ``smooth_kernel``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cross_patient_speech_decoding_tpu_torch.models.layers import (
    DayAffine,
    Dense,
    StackedRNN,
    _dropout,
    gaussian_kernel,
    smooth_time,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)


class BrainToTextGRU(nn.Module):
    """Day layers, input dropout, a windowed unidirectional GRU stack from
    one shared trainable initial state, a dense head per window; the
    keyword-only options give the '24 baseline: ``bidirectional``,
    ``learned_h0=False`` (a zero initial state, no ``h0`` parameter) and
    ``smooth_sigma`` (the smoothing over 20 frames before the day layer,
    :func:`~.layers.gaussian_kernel`; None: none).

    Trains with :func:`~cross_patient_speech_decoding_tpu_torch.train.steps.
    make_ctc_train_step` on batches that carry each row's day. Weights are
    drawn from ``seed`` with a CPU ``torch.Generator`` as the NEJM model
    draws them (identity day maps, xavier-uniform ``wi`` and ``h0``,
    orthogonal ``wh``, xavier-uniform head kernel), in that order, then
    moved to ``device`` (default: the first CUDA card; raises without one).
    """

    def __init__(self, in_channels: int = 512, hidden: int = 768,
                 n_layers: int = 5, n_classes: int = 41, n_days: int = 45,
                 input_dropout: float = 0.2, dropout: float = 0.4,
                 win_size: int = 14, stride: int = 4, blank: int = 0,
                 seed: int = 0, device=None, *, bidirectional: bool = False,
                 learned_h0: bool = True, smooth_sigma: float | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.in_channels = in_channels
        self.hidden = hidden
        self.n_layers = n_layers
        self.n_classes = n_classes
        self.n_days = n_days
        self.input_dropout = input_dropout
        self.win_size = win_size
        self.stride = stride
        self.blank = blank
        gen = torch.Generator().manual_seed(seed)

        self.register_buffer("smooth_kernel", None if smooth_sigma is None
                             else gaussian_kernel(smooth_sigma))
        self.day = DayAffine(n_days, in_channels)
        self.register_parameter("h0", None)
        if learned_h0:
            # xavier_uniform on (1, 1, H): fan_in = fan_out = H
            self.h0 = nn.Parameter(torch.empty(1, 1, hidden))
            lim = math.sqrt(6.0 / (2 * hidden))
            nn.init.uniform_(self.h0, -lim, lim, generator=gen)
        self.rnn = StackedRNN(win_size * in_channels, hidden, n_layers,
                              dropout=dropout, bidirectional=bidirectional,
                              generator=gen)
        self.head = Dense(hidden * (2 if bidirectional else 1), n_classes,
                          generator=gen)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.head.kernel, generator=gen)
            b = 1.0 / math.sqrt(hidden)
            self.head.bias.uniform_(-b, b, generator=gen)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.day.w.device

    def initial_hidden(self, batch: int = 1):
        """The one trainable state for every layer, (n_layers, batch, H);
        its gradient sums over layers and batch. None without a learned
        state: the stack starts from zeros."""
        if self.h0 is None:
            return None
        return self.h0.expand(self.n_layers, batch, self.hidden)

    def forward(self, x, days, generator: torch.Generator | None = None):
        """x (B, T, C) float32 frames, days (B,) each row's day (a host
        tensor keeps the step free of a device read) -> logits (B, n_win,
        n_classes). ``generator`` draws the dropout masks in training
        mode: the day layer's first, then the stack's between layers."""
        if self.smooth_kernel is not None:
            x = smooth_time(x, self.smooth_kernel)
        y = self.day(x, days)
        if self.training and self.input_dropout > 0:
            y = _dropout(y, self.input_dropout, generator)
        out, _ = self.rnn(y, self.initial_hidden(x.shape[0]),
                          window=(self.win_size, self.stride),
                          generator=generator)
        return self.head(out)
