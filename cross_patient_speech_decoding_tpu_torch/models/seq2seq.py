"""Seq2seq phoneme-sequence model and the GRU classifiers (offline NN
family).

Port of ``cross_patient_speech_decoding_tpu/models/seq2seq.py``
(``EncoderRNN``, ``DecoderRNN``, ``Seq2SeqRNN``, ``SimpleGRU``,
``TemporalConvRNN``): for the seq2seq model a temporal conv, a
bidirectional GRU or LSTM encoder whose last layer's forward and reverse
last states are summed, and an autoregressive decoder of the same cell that
starts from the token ``num_classes`` and feeds back its argmax (the first
index on ties) or, with teacher forcing, the label. The two classifiers
read the last time step of a unidirectional GRU stack, on the data
(``SimpleGRU``) or after a temporal conv (``TemporalConvRNN``).

Random draws in training mode come from the ``generator`` given to
``forward`` (the JAX step's 'dropout' and 'tf' keys), in this order: the
conv's dropout mask, the encoder's inter-layer masks (none at one layer),
the ``seq_length`` teacher-forcing coins in one draw (one coin per step for
the whole batch, reference models.py:295), then at each decoder step its
inter-layer masks (none at one layer). With the default one-layer encoder
and decoder that is: dropout masks first, then the coins.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cross_patient_speech_decoding_tpu_torch.models.layers import (
    Dense,
    StackedRNN,
    TemporalConv,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` (n, H), initialised N(0, 1/H)."""

    def __init__(self, n: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n, features))
        nn.init.normal_(self.embedding, 0.0, math.sqrt(1.0 / features),
                        generator=generator)

    def forward(self, token):
        return F.embedding(token, self.embedding)


class EncoderRNN(nn.Module):
    """Bidirectional GRU or LSTM stack; returns (out (B, T, 2H), the last
    layer's forward + reverse last states (B, H)). For an LSTM both h and
    c are summed and returned as an (h, c) pair, as in the JAX package
    (models/seq2seq.py:52-55, where this fixes the reference's own LSTM
    path, which crashes on its tuple state)."""

    def __init__(self, in_features: int, hidden: int, n_layers: int = 1,
                 dropout: float = 0.3, cell: str = "gru",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.rnn = StackedRNN(in_features, hidden, n_layers, dropout=dropout,
                              bidirectional=True, cell=cell,
                              generator=generator)

    def forward(self, x, generator: torch.Generator | None = None):
        out, lasts = self.rnn(x, generator=generator)
        if isinstance(lasts, tuple):
            h, c = lasts
            return out, (h[-2] + h[-1], c[-2] + c[-1])
        return out, lasts[-2] + lasts[-1]


class DecoderRNN(nn.Module):
    """Embedding + GRU or LSTM stack + dense head, one token step at a
    time."""

    def __init__(self, hidden: int, num_classes: int, n_layers: int = 1,
                 dropout: float = 0.3, cell: str = "gru",
                 generator: torch.Generator | None = None):
        super().__init__()
        # +1 row for the start token (= num_classes)
        self.embed = Embed(num_classes + 1, hidden, generator)
        self.rnn = StackedRNN(hidden, hidden, n_layers, dropout=dropout,
                              cell=cell, generator=generator)
        self.head = Dense(hidden, num_classes, generator)

    def forward(self, token, hidden, generator: torch.Generator | None = None):
        """token (B,) int; hidden (n_layers, B, H), an (h, c) pair of them
        for an LSTM -> (logits (B, num_classes), new hidden of the same
        form)."""
        e = self.embed(token)[:, None, :]  # (B, 1, H)
        out, new_hidden = self.rnn(e, hidden, generator=generator)
        return self.head(out[:, 0, :]), new_hidden


class Seq2SeqRNN(nn.Module):
    """TemporalConv -> bidirectional encoder -> autoregressive decoder
    (reference models.py:208-390).

    ``in_channels`` is the channel count C of the (B, T, C) input. Weights
    are drawn from ``seed`` with a CPU ``torch.Generator`` (flax's
    initialisers, not flax's numbers), then moved to ``device`` (default:
    the first CUDA card; raises without one).
    """

    def __init__(self, in_channels: int, n_filters: int, hidden: int,
                 num_classes: int, n_enc_layers: int = 1,
                 n_dec_layers: int = 1, kernel_size: int = 10,
                 stride: int = 1, cnn_dropout: float = 0.3,
                 rnn_dropout: float = 0.3, cell: str = "gru",
                 seq_length: int = 3, activation: bool = True,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.hidden = hidden
        self.num_classes = num_classes
        self.n_dec_layers = n_dec_layers
        self.seq_length = seq_length
        gen = torch.Generator().manual_seed(seed)
        self.conv = TemporalConv(in_channels, n_filters, kernel_size, stride,
                                 dropout=cnn_dropout, activation=activation,
                                 generator=gen)
        self.encoder = EncoderRNN(n_filters, hidden, n_enc_layers,
                                  rnn_dropout, cell, gen)
        self.decoder = DecoderRNN(hidden, num_classes, n_dec_layers,
                                  rnn_dropout, cell, gen)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.conv.weight.device

    def forward(self, x, y=None, teacher_forcing_ratio: float = 0.5,
                generator: torch.Generator | None = None):
        """x (B, T, C); y (B, seq_length) labels or None -> logits
        (B, seq_length, num_classes). Teacher forcing applies when y is
        given and the ratio is > 0: at step i the label y[:, i] is fed back
        where coin i < ratio, else the argmax."""
        B = x.shape[0]
        x = self.conv(x, generator)
        _, enc_hidden = self.encoder(x, generator)
        shape = (self.n_dec_layers, B, self.hidden)
        if isinstance(enc_hidden, tuple):
            # an LSTM tiles both halves of its carry (models/seq2seq.py:130)
            hidden = tuple(s[None].expand(shape) for s in enc_hidden)
        else:
            hidden = enc_hidden[None].expand(shape)
        token = torch.full((B,), self.num_classes, dtype=torch.long,
                           device=x.device)
        use_tf = y is not None and teacher_forcing_ratio > 0
        if use_tf:
            coins = torch.rand(self.seq_length, generator=generator,
                               device=x.device)
        outputs = []
        for i in range(self.seq_length):
            logits, hidden = self.decoder(token, hidden, generator)
            outputs.append(logits)
            pred = logits.argmax(dim=-1)
            if use_tf:
                token = torch.where(coins[i] < teacher_forcing_ratio,
                                    y[:, i].long(), pred)
            else:
                token = pred
        return torch.stack(outputs, dim=1)


class SimpleGRU(nn.Module):
    """GRU stack -> dense head on the last time step (reference
    models.py:764-796). (B, T, F) -> logits (B, num_classes).

    The stack reads the data itself: with ``input_grad=False`` (the
    default, as in the JAX package) layer 0 reads it in bf16 and forms no
    dx (:class:`~cross_patient_speech_decoding_tpu_torch.models.layers.
    StackedRNN`). Weights from ``seed`` as :class:`Seq2SeqRNN`'s; the
    inter-layer dropout masks from the ``generator`` given to ``forward``.
    """

    def __init__(self, in_features: int, hidden: int, num_classes: int,
                 n_layers: int = 1, dropout: float = 0.3,
                 input_grad: bool = False, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        gen = torch.Generator().manual_seed(seed)
        self.rnn = StackedRNN(in_features, hidden, n_layers, dropout=dropout,
                              input_grad=input_grad, generator=gen)
        self.head = Dense(hidden, num_classes, gen)
        self.to(dev)

    def forward(self, x, generator: torch.Generator | None = None):
        out, _ = self.rnn(x, generator=generator)
        return self.head(out[:, -1, :])


class TemporalConvRNN(nn.Module):
    """TemporalConv -> unidirectional GRU stack -> optional ReLU dense
    layers -> dense head, on the last time step (reference
    models.py:111-205). (B, T, C) -> logits (B, num_classes).

    Every GRU layer's input trains (the conv's output), so each layer's
    backward forms its dx. Weights from ``seed`` as :class:`Seq2SeqRNN`'s;
    the conv's and the inter-layer dropout masks, in that order, from the
    ``generator`` given to ``forward``.
    """

    def __init__(self, in_channels: int, n_filters: int, hidden: int,
                 num_classes: int, kernel_size: int = 10, stride: int = 1,
                 n_layers: int = 1, cnn_dropout: float = 0.3,
                 rnn_dropout: float = 0.3, fc_dims: tuple = (),
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        gen = torch.Generator().manual_seed(seed)
        self.conv = TemporalConv(in_channels, n_filters, kernel_size, stride,
                                 dropout=cnn_dropout, generator=gen)
        self.rnn = StackedRNN(n_filters, hidden, n_layers,
                              dropout=rnn_dropout, generator=gen)
        dims = (hidden, *fc_dims)
        self.fc = nn.ModuleList(Dense(a, b, gen)
                                for a, b in zip(dims[:-1], dims[1:]))
        self.head = Dense(dims[-1], num_classes, gen)
        self.to(dev)

    def forward(self, x, generator: torch.Generator | None = None):
        x = self.conv(x, generator)
        out, _ = self.rnn(x, generator=generator)
        h = out[:, -1, :]
        for fc in self.fc:
            h = torch.relu(fc(h))
        return self.head(h)
